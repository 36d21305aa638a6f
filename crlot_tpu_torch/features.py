"""Spectral features on the port's STFT, in torch: mel filterbank / mel
spectrogram / MFCC, the classic spectral descriptors, LPC and cepstrum,
chroma / tonnetz / pseudo-CQT, PCEN, analytic-signal utilities, and the
inversion path back to audio (mfcc_to_mel -> mel_to_linear NNLS ->
Griffin-Lim).

Counterpart of `crlot_tpu/features.py`. A filterbank is a `[K, n_bands]`
matrix applied to the power spectrogram, and the MFCC's DCT-II another
constant matrix: IEEE fp32 products batched over frames (`_product`: B0's
fixed-order fp32 kernel on a CUDA tensor, `torch.matmul` on the CPU; TF32
stays off). The power spectrogram comes from the port's `stft`: the
folded-DFT products on a CUDA tensor, `torch.fft` on the CPU. The analytic
signal and the LPC envelope use `torch.fft`.

Every per-frame sum over bins or samples (centroid, bandwidth, flatness,
contrast, RMS, zero crossings, LPC's autocorrelation, tonnetz's
normalization, chroma_cqt's octave fold) runs in one fixed pairwise order
(`_sum_last`), so splitting the channels over shards changes no bit.

Design-time constants (filterbanks, DCT and tonnetz bases, band slices)
are copies of the reference's float64 numpy design code, byte-identical,
cached under the reference's keys behind a lock; their on-device copies are
cached under the same key and the device. Array-like input goes to
`device` (default "cuda", `core/device.py`); a tensor stays on its own
device.

Conventions (librosa / HTK where noted):
- mel scale: "slaney" (linear below 1 kHz, log above) or "htk"
  (2595 * log10(1 + f/700)).
- filterbank norm: "slaney" (equal-area) or None (unit peak).
- MFCC: DCT-II with orthonormal scaling over log-mel in dB (10*log10).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .core import device as _device
from .core.types import StftConfig

_CACHE: Dict[Tuple, np.ndarray] = {}
_CACHE_LOCK = threading.Lock()
_DEV_CACHE: Dict[Tuple, torch.Tensor] = {}


# ---------------------------------------------------------------------------
# mel scale + filterbank design (host, float64)
# ---------------------------------------------------------------------------

def hz_to_mel(f, htk: bool = False):
    """Hz -> mel. `htk=True` uses 2595*log10(1+f/700); default is the
    Slaney scale (linear below 1 kHz: f/66.67 mel; log above)."""
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3.0
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    mels = np.where(
        log_t,
        min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz(m, htk: bool = False):
    """Inverse of `hz_to_mel`."""
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3.0
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = m >= min_log_mel
    freqs = np.where(
        log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs
    )
    return freqs


def _cached(key):
    with _CACHE_LOCK:
        return _CACHE.get(key)


def _store(key, arr: np.ndarray) -> np.ndarray:
    with _CACHE_LOCK:
        return _CACHE.setdefault(key, arr)


def _on(key, arr: np.ndarray, device: torch.device,
        transpose: bool = False) -> torch.Tensor:
    """The cached host array `arr` (designed under `key`) as a contiguous
    f32 tensor on `device`, transposed if asked; uploaded once a device."""
    dkey = key + (str(device), transpose)
    with _CACHE_LOCK:
        hit = _DEV_CACHE.get(dkey)
    if hit is not None:
        return hit
    host = np.array(arr.T if transpose else arr, np.float32, order="C")
    t = torch.from_numpy(host).to(device)
    with _CACHE_LOCK:
        return _DEV_CACHE.setdefault(dkey, t)


def _melfb_key(sr, n_fft, n_mels, fmin, fmax, htk, norm):
    if fmax is None:
        fmax = sr / 2.0
    return ("melfb", float(sr), int(n_fft), int(n_mels), float(fmin),
            float(fmax), bool(htk), norm)


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int = 64,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank `[n_mels, n_fft//2 + 1]` (float32).

    Filters are triangles with vertices at `n_mels + 2` mel-equispaced
    frequencies in [fmin, fmax]; `norm="slaney"` scales each triangle to
    unit area (2 / bandwidth), `norm=None` leaves unit peaks. Designed in
    float64, cached (read-only), cast f32."""
    if fmax is None:
        fmax = sr / 2.0
    if not (0.0 <= fmin < fmax <= sr / 2.0 + 1e-9):
        raise ValueError(f"need 0 <= fmin < fmax <= sr/2, got [{fmin}, {fmax}]")
    if n_mels < 1:
        raise ValueError("n_mels must be >= 1")
    if norm not in (None, "slaney"):
        raise ValueError(f"unknown filterbank norm: {norm!r}")
    key = _melfb_key(sr, n_fft, n_mels, fmin, fmax, htk, norm)
    hit = _cached(key)
    if hit is not None:
        return hit

    fft_freqs = np.fft.rfftfreq(n_fft, d=1.0 / sr)  # [K] f64
    mel_pts = np.linspace(
        hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2
    )
    hz_pts = mel_to_hz(mel_pts, htk)  # [n_mels + 2]

    # Triangle m rises hz_pts[m] -> hz_pts[m+1], falls to hz_pts[m+2].
    lower = (fft_freqs[None, :] - hz_pts[:-2, None]) / np.maximum(
        hz_pts[1:-1, None] - hz_pts[:-2, None], 1e-30
    )
    upper = (hz_pts[2:, None] - fft_freqs[None, :]) / np.maximum(
        hz_pts[2:, None] - hz_pts[1:-1, None], 1e-30
    )
    fb = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb *= enorm[:, None]
    fb = np.ascontiguousarray(fb.astype(np.float32))
    fb.setflags(write=False)
    return _store(key, fb)


def _dct_ii_ortho(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix `[n_out, n_in]` (float32, cached): scipy's
    dct(type=2, norm="ortho") along the mel axis."""
    key = ("dct2", int(n_out), int(n_in))
    hit = _cached(key)
    if hit is not None:
        return hit
    k = np.arange(n_out, dtype=np.float64)[:, None]
    n = np.arange(n_in, dtype=np.float64)[None, :]
    mat = np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    mat *= np.sqrt(2.0 / n_in)
    mat[0] *= 1.0 / np.sqrt(2.0)
    mat = np.ascontiguousarray(mat.astype(np.float32))
    mat.setflags(write=False)
    return _store(key, mat)


# ---------------------------------------------------------------------------
# feature extractors
# ---------------------------------------------------------------------------

def _sum_last(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed pairwise order: zero-pad it to a
    power of two, then add its halves until one is left. Each step is an
    elementwise add, so a row's sum does not depend on how many rows the
    tensor holds (a reduction kernel's summation order on the card does:
    `torch.sum` over 513 bins of 22 502 frames and of 11 251 frames gave
    other bits), nor on the device."""
    n = t.shape[-1]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        t = torch.nn.functional.pad(t, (0, p - n))
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t[..., 0]


def _mean_last(t: torch.Tensor) -> torch.Tensor:
    return _sum_last(t) / t.shape[-1]


def _power_spectrogram(signal: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """|STFT|^2 `[..., F, K]`."""
    from .pipeline import stft

    spec = stft(signal, cfg)
    return torch.square(spec.real) + torch.square(spec.imag)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b [K, N] in IEEE fp32: `torch.matmul` on the CPU; on
    a CUDA tensor B0's fp32 kernel (`fft/fp32_window.py`), one fmaf chain an
    output over k ascending, so that a row's result does not depend on how
    many rows share the call. cuBLAS's order does (ROADMAP C15): chroma's
    [F, 513] x [513, 12] gave other bits for 11 251 frames than for 22 502.
    K and N are zero-padded to multiples of 4 (zeros add nothing to a
    chain)."""
    if a.device.type == "cpu":
        return torch.matmul(a, b)
    from .fft import fp32_window

    k, n = b.shape
    kp, np4 = -(-k // 4) * 4, -(-n // 4) * 4
    a = torch.nn.functional.pad(a, (0, kp - k)) if kp != k else a.contiguous()
    if a.data_ptr() % 16:
        a = a.clone()
    b = torch.nn.functional.pad(b, (0, np4 - n, 0, kp - k)).contiguous()
    out = fp32_window.gemm_cuda(a, b)
    return out[..., :n] if np4 != n else out


def mel_spectrogram(
    signal,
    cfg: StftConfig,
    sr: float,
    n_mels: int = 64,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
    device=None,
) -> torch.Tensor:
    """Mel power spectrogram `[..., T] -> [..., F, n_mels]`: the power
    spectrogram through the `[K, n_mels]` filterbank product."""
    x = _device.place(signal, device, torch.float32)
    fb = mel_filterbank(sr, cfg.frame_size, n_mels, fmin, fmax, htk, norm)
    key = _melfb_key(sr, cfg.frame_size, n_mels, fmin, fmax, htk, norm)
    return _product(_power_spectrogram(x, cfg),
                    _on(key, fb, x.device, transpose=True))


def power_to_db(p, floor_db: float = -100.0, ref: float = 1.0,
                device=None) -> torch.Tensor:
    """10*log10(p/ref), floored at `floor_db` (no -inf on silence)."""
    floor = 10.0 ** (floor_db / 10.0)
    p = _device.place(p, device)
    return 10.0 * torch.log10(torch.clamp_min(p / ref, floor))


def amplitude_to_db(a, floor_db: float = -100.0, ref: float = 1.0,
                    device=None) -> torch.Tensor:
    """20*log10(|a|/ref), floored at `floor_db` (no -inf on silence)."""
    floor = 10.0 ** (floor_db / 20.0)
    a = _device.place(a, device)
    return 20.0 * torch.log10(torch.clamp_min(torch.abs(a) / ref, floor))


def db_to_power(db, ref: float = 1.0, device=None) -> torch.Tensor:
    """Inverse of `power_to_db` (above its floor): ref * 10^(db/10)."""
    return ref * torch.pow(10.0, _device.place(db, device) / 10.0)


def db_to_amplitude(db, ref: float = 1.0, device=None) -> torch.Tensor:
    """Inverse of `amplitude_to_db` (above its floor): ref * 10^(db/20)."""
    return ref * torch.pow(10.0, _device.place(db, device) / 20.0)


def magphase(spec, device=None):
    """Split a complex spectrogram into (magnitude, unit-phasor) with
    `mag * phasor == spec`; zero bins get phasor 1 (not NaN)."""
    spec = _device.place(spec, device)
    mag = torch.abs(spec)
    nz = mag > 0
    phasor = torch.where(nz, spec / torch.where(nz, mag, 1.0),
                         torch.ones((), dtype=spec.dtype, device=spec.device))
    return mag, phasor


def mfcc(
    signal,
    cfg: StftConfig,
    sr: float,
    n_mfcc: int = 13,
    n_mels: int = 64,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
    floor_db: float = -100.0,
    device=None,
) -> torch.Tensor:
    """MFCCs `[..., T] -> [..., F, n_mfcc]`: orthonormal DCT-II of the
    dB log-mel spectrogram (librosa convention)."""
    if n_mfcc > n_mels:
        raise ValueError(f"n_mfcc ({n_mfcc}) must be <= n_mels ({n_mels})")
    mel = mel_spectrogram(signal, cfg, sr, n_mels, fmin, fmax, htk, norm,
                          device=device)
    logmel = power_to_db(mel, floor_db)
    dct_t = _on(("dct2", int(n_mfcc), int(n_mels)),
                _dct_ii_ortho(n_mfcc, n_mels), mel.device, transpose=True)
    return _product(logmel, dct_t)


# ---------------------------------------------------------------------------
# spectral descriptors (per frame)
# ---------------------------------------------------------------------------

def _freqs(cfg: StftConfig, sr: float, device) -> torch.Tensor:
    key = ("freqs", int(cfg.frame_size), float(sr))
    hit = _cached(key)
    if hit is None:
        hit = _store(key, np.fft.rfftfreq(cfg.frame_size, d=1.0 / sr)
                     .astype(np.float32))
    return _on(key, hit, device)


def spectral_centroid(signal, cfg: StftConfig, sr: float,
                      device=None) -> torch.Tensor:
    """Magnitude-weighted mean frequency per frame `[..., T] -> [..., F]`
    (Hz). Silent frames return 0."""
    p = _power_spectrogram(_device.place(signal, device, torch.float32), cfg)
    mag = torch.sqrt(p)
    f = _freqs(cfg, sr, p.device)
    num = _sum_last(mag * f)
    den = _sum_last(mag)
    return torch.where(den > 0, num / torch.clamp_min(den, 1e-30), 0.0)


def spectral_bandwidth(signal, cfg: StftConfig, sr: float,
                       device=None) -> torch.Tensor:
    """Magnitude-weighted std of frequency about the centroid, per frame
    (Hz). Silent frames return 0."""
    p = _power_spectrogram(_device.place(signal, device, torch.float32), cfg)
    mag = torch.sqrt(p)
    f = _freqs(cfg, sr, p.device)
    total = _sum_last(mag)
    den = torch.clamp_min(total, 1e-30)
    cent = _sum_last(mag * f) / den
    var = _sum_last(mag * torch.square(f - cent[..., None])) / den
    return torch.where(total > 0, torch.sqrt(torch.clamp_min(var, 0.0)), 0.0)


def spectral_rolloff(signal, cfg: StftConfig, sr: float,
                     roll_percent: float = 0.85,
                     device=None) -> torch.Tensor:
    """Lowest frequency per frame below which `roll_percent` of the total
    spectral energy lies `[..., T] -> [..., F]` (Hz)."""
    p = _power_spectrogram(_device.place(signal, device, torch.float32), cfg)
    csum = torch.cumsum(p, dim=-1)
    thresh = roll_percent * csum[..., -1:]
    f = _freqs(cfg, sr, p.device)
    # The first bin where the cumulative energy reaches the threshold.
    idx = torch.argmax((csum >= thresh).to(torch.uint8), dim=-1)
    return f[idx]


def chroma_filterbank(
    sr: float,
    n_fft: int,
    n_chroma: int = 12,
    sigma: float = 1.0,
    fmin: float = 32.0,
) -> np.ndarray:
    """Chroma (pitch-class) filterbank `[n_chroma, n_fft//2 + 1]` (f32).

    Each FFT bin's fractional pitch p = n_chroma * log2(f / C0) (C0 =
    16.3516 Hz, so class 0 = C) is spread over classes with a wrapped
    Gaussian of width `sigma` semitones; bins below `fmin` are zeroed.
    Columns are L1-normalized. Designed f64, cached. Reliable chroma for a
    pitch f needs bin spacing sr/n_fft well under a semitone (~f/17)."""
    if n_chroma < 2:
        raise ValueError("n_chroma must be >= 2")
    key = ("chromafb", float(sr), int(n_fft), int(n_chroma), float(sigma),
           float(fmin))
    hit = _cached(key)
    if hit is not None:
        return hit
    c0 = 440.0 / 16.0 * (2.0 ** (-9.0 / 12.0))  # C0 = 16.3516 Hz
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / sr)
    valid = freqs >= fmin
    p = np.zeros_like(freqs)
    p[valid] = n_chroma * np.log2(freqs[valid] / c0)
    classes = np.arange(n_chroma)[:, None]
    dist = (p[None, :] - classes) % n_chroma
    dist = np.minimum(dist, n_chroma - dist)  # wrapped distance
    fb = np.exp(-0.5 * (dist / sigma) ** 2)
    fb[:, ~valid] = 0.0
    col = fb.sum(axis=0, keepdims=True)
    fb = np.where(col > 0, fb / np.maximum(col, 1e-12), 0.0)
    fb = np.ascontiguousarray(fb.astype(np.float32))
    fb.setflags(write=False)
    return _store(key, fb)


def chroma(
    signal,
    cfg: StftConfig,
    sr: float,
    n_chroma: int = 12,
    sigma: float = 1.0,
    fmin: float = 32.0,
    device=None,
) -> torch.Tensor:
    """Chroma energy per frame `[..., T] -> [..., F, n_chroma]` (class 0 =
    C): the power spectrogram through the chroma filterbank product."""
    x = _device.place(signal, device, torch.float32)
    fb = chroma_filterbank(sr, cfg.frame_size, n_chroma, sigma, fmin)
    key = ("chromafb", float(sr), int(cfg.frame_size), int(n_chroma),
           float(sigma), float(fmin))
    return _product(_power_spectrogram(x, cfg),
                    _on(key, fb, x.device, transpose=True))


def delta(feat, width: int = 9, order: int = 1, device=None) -> torch.Tensor:
    """Regression delta of a feature track along the FRAME axis
    (`[..., F, D] -> [..., F, D]`, librosa.feature.delta convention):
    delta[t] = sum_{d=-W}^{W} d * x[t+d] / sum_d d^2 with edge padding.
    `order=2` applies it twice (delta-delta)."""
    if width < 3 or width % 2 == 0:
        raise ValueError("width must be an odd integer >= 3")
    if order < 1:
        raise ValueError("order must be >= 1")
    half = width // 2
    d = np.arange(-half, half + 1, dtype=np.float64)
    kernel = (d / np.sum(d * d)).astype(np.float32)
    x = _device.place(feat, device, torch.float32)
    for _ in range(order):
        f = x.shape[-2]
        idx = torch.clamp(torch.arange(-half, f + half, device=x.device),
                          0, f - 1)
        pad = x.index_select(-2, idx)  # edge padding along frames
        acc = float(kernel[0]) * pad[..., 0:f, :]
        for k in range(1, width):
            acc = acc + float(kernel[k]) * pad[..., k : k + f, :]
        x = acc
    return x


# ---------------------------------------------------------------------------
# linear prediction
# ---------------------------------------------------------------------------

def lpc(signal, cfg: StftConfig, order: int = 16, eps: float = 1e-9,
        device=None) -> torch.Tensor:
    """Per-frame LPC coefficients `[..., T] -> [..., F, order+1]` by the
    autocorrelation method (Levinson-Durbin), windowed with `cfg`'s window.

    Returns the all-pole polynomial A(z) = 1 + a_1 z^-1 + ... + a_p z^-p
    (a[..., 0] == 1; librosa.lpc convention). The recursion runs `order`
    vectorized steps over all frames at once, in the reference's update
    order. Silent frames return a[0]=1, rest 0 (eps-guarded)."""
    if order < 1:
        raise ValueError("order must be >= 1")
    if order >= cfg.frame_size:
        raise ValueError(
            f"order ({order}) must be < frame_size ({cfg.frame_size})"
        )
    from .core.consts import const_on
    from .frame.framing import frame_signal
    from .window.windows import get_window

    x = _device.place(signal, device, torch.float32)
    frames = frame_signal(x, cfg.frame_spec)
    w = const_on(get_window(cfg.window, cfg.frame_size, cfg.periodic),
                 x.device)
    frames = frames * w
    t = cfg.frame_size
    # Autocorrelation lags 0..order (order+1 shifted dot products).
    r = torch.stack(
        [_sum_last(frames[..., : t - k] * frames[..., k:])
         for k in range(order + 1)],
        dim=-1,
    )  # [..., F, order+1]

    # Levinson-Durbin, vectorized over the leading (frame) axes.
    a = [torch.ones_like(r[..., 0])] + [torch.zeros_like(r[..., 0])
                                        for _ in range(order)]
    err = r[..., 0]
    for i in range(1, order + 1):
        acc = r[..., i]
        for j in range(1, i):
            acc = acc + a[j] * r[..., i - j]
        k = -acc / (err + eps)
        new = [a[j] + k * a[i - j] for j in range(1, i)]
        for j in range(1, i):
            a[j] = new[j - 1]
        a[i] = k
        err = err * (1.0 - k * k)
    return torch.stack(a, dim=-1)


def lpc_envelope_db(a, n_fft: int, device=None) -> torch.Tensor:
    """All-pole spectral envelope from LPC coefficients:
    `[..., order+1] -> [..., n_fft//2+1]` in dB, -20*log10|A(e^jw)|
    (gain-free shape; add the frame's error power for absolute level)."""
    a = _device.place(a, device, torch.float32)
    spec = torch.fft.rfft(a, n=n_fft, dim=-1)
    mag = torch.sqrt(torch.square(spec.real) + torch.square(spec.imag))
    return -20.0 * torch.log10(torch.clamp_min(mag, 1e-12))


def real_cepstrum(signal, cfg: StftConfig, eps: float = 1e-10,
                  device=None) -> torch.Tensor:
    """Per-frame real cepstrum `[..., T] -> [..., F, frame_size]`:
    irfft(log |STFT|) — an echo at lag d puts a peak at quefrency d."""
    from .pipeline import stft

    spec = stft(_device.place(signal, device, torch.float32), cfg)
    logmag = 0.5 * torch.log(torch.clamp_min(
        torch.square(spec.real) + torch.square(spec.imag), eps * eps))
    return torch.fft.irfft(logmag.to(torch.complex64), n=cfg.frame_size,
                           dim=-1)


# ---------------------------------------------------------------------------
# inversion: MFCC -> mel -> linear power -> audio
# ---------------------------------------------------------------------------

def mfcc_to_mel(coeffs, n_mels: int = 64, floor_db: float = -100.0,
                device=None) -> torch.Tensor:
    """Invert `mfcc`: `[..., F, n_mfcc] -> [..., F, n_mels]` mel POWER.

    The DCT-II is orthonormal, so truncation to n_mfcc coefficients makes
    this the least-squares inverse (exact when n_mfcc == n_mels); the dB
    log is inverted exactly down to its floor."""
    coeffs = _device.place(coeffs, device, torch.float32)
    n_mfcc = coeffs.shape[-1]
    if n_mfcc > n_mels:
        raise ValueError(f"n_mfcc ({n_mfcc}) must be <= n_mels ({n_mels})")
    dct = _on(("dct2", int(n_mfcc), int(n_mels)),
              _dct_ii_ortho(n_mfcc, n_mels), coeffs.device)
    logmel = _product(coeffs, dct)  # orthonormal: transpose inverse
    return torch.pow(10.0, torch.clamp_min(logmel, floor_db) / 10.0)


def mel_to_linear(
    mel_power,
    sr: float,
    n_fft: int,
    n_mels: int = 64,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
    iters: int = 32,
    device=None,
) -> torch.Tensor:
    """Approximately invert the mel filterbank:
    `[..., F, n_mels] -> [..., F, n_fft//2+1]` nonnegative linear power.

    Solves min ||fb @ s - mel||_2 with s >= 0 per frame by multiplicative
    (Lee-Seung) updates, `iters` steps of a pair of `[K, n_mels]` products
    (the reference's `fori_loop` as a Python loop)."""
    mel_power = torch.clamp_min(
        _device.place(mel_power, device, torch.float32), 0.0)
    key = _melfb_key(sr, n_fft, n_mels, fmin, fmax, htk, norm)
    fb_host = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm)
    fb = _on(key, fb_host, mel_power.device)  # [M, K]
    fb_t = _on(key, fb_host, mel_power.device, transpose=True)  # [K, M]
    num = _product(mel_power, fb)  # fb^T per frame (row convention)
    s = num  # transpose-map init: nonnegative, right support
    for _ in range(iters):
        den = _product(_product(s, fb_t), fb) + 1e-12
        s = s * num / den
    return s


def mel_to_audio(
    mel_power,
    cfg: StftConfig,
    sr: float,
    n_mels: int = 64,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
    nnls_iters: int = 32,
    gl_iters: int = 32,
    length: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Mel power spectrogram -> waveform: NNLS filterbank inversion
    (`mel_to_linear`) then Griffin-Lim phase reconstruction (seed 0)."""
    from .griffinlim import griffin_lim

    p = mel_to_linear(mel_power, sr, cfg.frame_size, n_mels, fmin, fmax,
                      htk, norm, iters=nnls_iters, device=device)
    mag = torch.sqrt(torch.clamp_min(p, 0.0))
    return griffin_lim(mag, cfg, iters=gl_iters, length=length)


# ---------------------------------------------------------------------------
# analytic signal (Hilbert) utilities
# ---------------------------------------------------------------------------

def _analytic(x: torch.Tensor) -> torch.Tensor:
    """Analytic signal via the frequency-domain Hilbert construction
    (scipy.signal.hilbert): one-sided spectrum doubling, complex ifft."""
    from .core.consts import const_on

    t = x.shape[-1]
    spec = torch.fft.fft(x, dim=-1)
    h = np.zeros(t)
    h[0] = 1.0
    if t % 2 == 0:
        h[t // 2] = 1.0
        h[1 : t // 2] = 2.0
    else:
        h[1 : (t + 1) // 2] = 2.0
    return torch.fft.ifft(spec * const_on(h, x.device), dim=-1)


def envelope(signal, device=None) -> torch.Tensor:
    """Instantaneous amplitude |analytic(x)| of `[..., T]` (the Hilbert
    envelope; abs(scipy.signal.hilbert(x)))."""
    return torch.abs(_analytic(_device.place(signal, device, torch.float32)))


def instantaneous_frequency(signal, sr: float, device=None) -> torch.Tensor:
    """Instantaneous frequency (Hz) of `[..., T] -> [..., T-1]`: the
    wrapped first difference of the analytic phase, angle(a[t+1] *
    conj(a[t])) (already wrapped to (-pi, pi])."""
    a = _analytic(_device.place(signal, device, torch.float32))
    prod = a[..., 1:] * torch.conj(a[..., :-1])
    dphi = torch.atan2(prod.imag, prod.real)
    return dphi * (sr / (2.0 * np.pi))


def frame_rms(signal, cfg: StftConfig, device=None) -> torch.Tensor:
    """Per-frame RMS level `[..., T] -> [..., F]` over the raw (unwindowed)
    frames of `cfg`'s framing."""
    from .frame.framing import frame_signal

    frames = frame_signal(_device.place(signal, device, torch.float32),
                          cfg.frame_spec)
    return torch.sqrt(_mean_last(torch.square(frames)))


def zero_crossing_rate(signal, cfg: StftConfig, device=None) -> torch.Tensor:
    """Per-frame zero-crossing rate `[..., T] -> [..., F]` in [0, 1]: the
    fraction of adjacent sample pairs in the frame whose signs differ
    (zero counts as nonnegative)."""
    from .frame.framing import frame_signal

    frames = frame_signal(_device.place(signal, device, torch.float32),
                          cfg.frame_spec)
    pos = frames >= 0
    flips = pos[..., 1:] != pos[..., :-1]
    return _mean_last(flips.to(torch.float32))


def spectral_flatness(signal, cfg: StftConfig, eps: float = 1e-10,
                      device=None) -> torch.Tensor:
    """Wiener entropy per frame: geometric / arithmetic mean of the power
    spectrum, in (0, 1]. ~1 for white noise, ~0 for a pure tone."""
    p = _power_spectrogram(_device.place(signal, device, torch.float32),
                           cfg) + eps
    log_gm = _mean_last(torch.log(p))
    am = _mean_last(p)
    return torch.exp(log_gm) / am


def _contrast_band_slices(
    sr: float, n_fft: int, n_bands: int, fmin: float
) -> Tuple[Tuple[int, int], ...]:
    """Octave-band bin ranges for spectral contrast: band 0 = [0, fmin),
    band b = [fmin*2^(b-1), fmin*2^b) Hz, the last band clipped at
    Nyquist. Every band must hold at least 2 bins."""
    k = n_fft // 2 + 1
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    edges = [0.0] + [fmin * (2.0 ** b) for b in range(n_bands + 1)]
    edges[-1] = min(edges[-1], sr / 2.0)
    out = []
    for lo_hz, hi_hz in zip(edges[:-1], edges[1:]):
        lo = int(np.searchsorted(freqs, lo_hz, side="left"))
        hi = int(np.searchsorted(freqs, hi_hz, side="left"))
        hi = min(max(hi, lo + 2), k)
        if hi - lo < 2 or lo >= k - 1:
            raise ValueError(
                f"spectral_contrast band [{lo_hz:.0f}, {hi_hz:.0f}) Hz has "
                f"<2 bins at n_fft={n_fft}, sr={sr}; lower n_bands or fmin"
            )
        out.append((lo, hi))
    return tuple(out)


def spectral_contrast(
    signal,
    cfg: StftConfig,
    sr: float,
    n_bands: int = 6,
    fmin: float = 200.0,
    quantile: float = 0.02,
    linear: bool = False,
    device=None,
) -> torch.Tensor:
    """Octave-band spectral contrast `[..., T] -> [..., F, n_bands+1]`:
    per frame and band, the gap between the mean of the top `quantile` of
    power bins (peak) and the mean of the bottom `quantile` (valley) — in
    dB by default, as a linear peak/valley ratio with `linear=True`. Each
    band is a static slice sorted along its bins."""
    if not 0.0 < quantile <= 0.5:
        raise ValueError(f"quantile must be in (0, 0.5], got {quantile}")
    p = _power_spectrogram(_device.place(signal, device, torch.float32), cfg)
    bands = _contrast_band_slices(sr, cfg.frame_size, n_bands, fmin)
    cols = []
    for lo, hi in bands:
        nb = hi - lo
        k = max(1, int(round(quantile * nb)))
        s = torch.sort(p[..., lo:hi], dim=-1).values
        valley = _mean_last(s[..., :k])
        peak = _mean_last(s[..., nb - k:])
        ratio = torch.clamp_min(peak, 1e-20) / torch.clamp_min(valley, 1e-20)
        cols.append(ratio if linear else 10.0 * torch.log10(ratio))
    return torch.stack(cols, dim=-1)


def _tonnetz_basis(n_chroma: int) -> np.ndarray:
    """Harte/Sandler/Gasser 2006 tonal-centroid projection `[6, n_chroma]`:
    pitch classes on three circles — fifths (radius 1), minor thirds
    (radius 1), major thirds (radius 0.5) — as (sin, cos) pairs. Designed
    in float64, cached by key."""
    key = ("tonnetz", n_chroma)
    hit = _cached(key)
    if hit is not None:
        return hit
    l = np.arange(n_chroma, dtype=np.float64) * (12.0 / n_chroma)
    angles = np.vstack([
        l * 7.0 * np.pi / 6.0,   # circle of fifths
        l * 3.0 * np.pi / 2.0,   # minor thirds
        l * 2.0 * np.pi / 3.0,   # major thirds
    ])
    radii = np.array([1.0, 1.0, 0.5])[:, None]
    basis = np.empty((6, n_chroma), np.float64)
    basis[0::2] = radii * np.sin(angles)
    basis[1::2] = radii * np.cos(angles)
    return _store(key, basis.astype(np.float32))


def tonnetz(
    signal,
    cfg: StftConfig,
    sr: float,
    n_chroma: int = 12,
    sigma: float = 1.0,
    fmin: float = 32.0,
    device=None,
) -> torch.Tensor:
    """Tonal centroid features `[..., T] -> [..., F, 6]`: the chroma vector
    (L1-normalized per frame) projected onto the fifths / minor-third /
    major-third circles; one [6, n_chroma] product on top of `chroma`."""
    c = chroma(signal, cfg, sr, n_chroma=n_chroma, sigma=sigma, fmin=fmin,
               device=device)
    c = c / torch.clamp_min(_sum_last(c)[..., None], 1e-10)
    basis_t = _on(("tonnetz", n_chroma), _tonnetz_basis(n_chroma), c.device,
                  transpose=True)
    return _product(c, basis_t)


def _pow(base: torch.Tensor, exponent: float) -> torch.Tensor:
    """float32 base ** exponent, computed in float64 and rounded once. The
    CPU's vectorized float32 pow and its scalar loop over a tensor's
    remainder differ by an ulp, so a float32 pow would depend on where an
    element falls in its tensor (and so on the channel sharding)."""
    return torch.pow(base.double(), exponent).float()


def pcen(
    spec,
    frame_rate: float,
    time_constant: float = 0.4,
    gain: float = 0.98,
    bias: float = 2.0,
    power: float = 0.5,
    eps: float = 1e-6,
    zi=None,
    device=None,
):
    """Per-channel energy normalization (Wang et al. 2017) of a
    nonnegative spectrogram `[..., F, K]` (frames on axis -2, e.g. a mel
    spectrogram): an automatic-gain-control divide by a one-pole temporal
    smoother, then root compression —

        M[t] = (1-s) M[t-1] + s S[t]
        PCEN = (S / (eps + M)^gain + bias)^power - bias^power

    `frame_rate` = sr / hop_size; s = (sqrt(1 + 4 T^2) - 1) / (2 T^2) with
    T = time_constant * frame_rate (librosa). The smoother is the log-depth
    scan IIR (`iir.lfilter`) along frames, initialized at M[-1] = S[0].

    Streaming: pass `zi` = the previous chunk's final smoother state
    `[..., K]` (the second element of the returned tuple); with `zi` the
    function returns `(out, zf)` instead of `out` alone."""
    from .iir import _state_like, lfilter

    if time_constant <= 0 or frame_rate <= 0:
        raise ValueError("frame_rate and time_constant must be > 0")
    t = time_constant * frame_rate
    s = float((np.sqrt(1.0 + 4.0 * t * t) - 1.0) / (2.0 * t * t))
    x = torch.clamp_min(_device.place(spec, device, torch.float32), 0.0)
    xt = torch.swapaxes(x, -2, -1)  # [..., K, F]: smooth along last axis
    one_minus_s = float(np.float32(1.0 - s))
    if zi is None:
        z0 = one_minus_s * xt[..., :1]  # DF2T state for M[-1] = S[0]
    else:
        z0 = one_minus_s * _state_like(zi, x)[..., None]
    m, _ = lfilter([s], [1.0, -(1.0 - s)], xt, zi=z0)
    m = torch.swapaxes(m, -2, -1)
    agc = x / _pow(eps + m, gain)
    out = _pow(agc + bias, power) - bias ** power
    if zi is None:
        return out
    return out, m[..., -1, :]


def cqt_filterbank(
    sr: float,
    n_fft: int,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    fmin: float = 32.703194,  # C1
) -> np.ndarray:
    """Constant-Q analysis filterbank `[n_bins, n_fft//2 + 1]` (host f64,
    cached): bin b is a Gaussian centered at fmin * 2^(b/bins_per_octave)
    whose width tracks the constant-Q bandwidth f/Q with
    Q = 1 / (2^(1/bpo) - 1), floored at one FFT bin. Rows are
    L1-normalized (unit response to a flat spectrum)."""
    key = ("cqt", float(sr), n_fft, n_bins, bins_per_octave, float(fmin))
    hit = _cached(key)
    if hit is not None:
        return hit
    if fmin <= 0 or n_bins < 1 or bins_per_octave < 1:
        raise ValueError("fmin > 0, n_bins >= 1, bins_per_octave >= 1")
    centers = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    if centers[-1] > sr / 2.0:
        raise ValueError(
            f"top CQT bin {centers[-1]:.1f} Hz exceeds Nyquist {sr / 2:.1f}; "
            f"lower n_bins or fmin"
        )
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    df = sr / n_fft
    # FWHM = bandwidth -> sigma = bw / (2 sqrt(2 ln 2)).
    bw = np.maximum(centers / q, df)
    sigma = bw / 2.3548200450309493
    fb = np.exp(
        -0.5 * ((freqs[None, :] - centers[:, None]) / sigma[:, None]) ** 2
    )
    fb /= np.maximum(fb.sum(axis=1, keepdims=True), 1e-12)
    return _store(key, fb.astype(np.float32))


def pseudo_cqt(
    signal,
    cfg: StftConfig,
    sr: float,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    fmin: float = 32.703194,
    device=None,
) -> torch.Tensor:
    """Pseudo constant-Q power spectrogram `[..., T] -> [..., F, n_bins]`:
    the STFT power spectrogram through the constant-Q filterbank product
    (frequency resolution at the low bins bounded by sr/n_fft)."""
    x = _device.place(signal, device, torch.float32)
    fb = cqt_filterbank(sr, cfg.frame_size, n_bins, bins_per_octave, fmin)
    key = ("cqt", float(sr), cfg.frame_size, n_bins, bins_per_octave,
           float(fmin))
    return _product(_power_spectrogram(x, cfg),
                    _on(key, fb, x.device, transpose=True))


def chroma_cqt(
    signal,
    cfg: StftConfig,
    sr: float,
    n_octaves: int = 7,
    fmin: float = 32.703194,  # C1 -> pitch class 0 = C
    device=None,
) -> torch.Tensor:
    """Chroma from the pseudo-CQT `[..., T] -> [..., F, 12]`: 12 bins per
    octave from `fmin`, folded across `n_octaves` octaves by summation.
    Class 0 = C when `fmin` is a C."""
    c = pseudo_cqt(signal, cfg, sr, n_bins=12 * n_octaves,
                   bins_per_octave=12, fmin=fmin, device=device)
    c = c.reshape(c.shape[:-1] + (n_octaves, 12))
    return _sum_last(c.transpose(-1, -2))
