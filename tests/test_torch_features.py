"""The port's spectral features (`crlot_tpu_torch.features`) on the CPU:
mel filterbank / mel spectrogram / MFCC, the descriptors, LPC, cepstrum,
the inversion path, the Hilbert utilities, chroma and delta.

Mirrors `tests/test_features.py` case for case with its gates (the
brute-force filterbank oracle at rtol 1e-5, the mel as a power product at
rtol 2e-4, scipy's DCT of the log-mel at atol 2e-3, LPC against the normal
equations at rtol 5e-3 / atol 5e-4, scipy's Hilbert envelope at 2e-4, and
the tone and noise gates), then holds the port against the reference on
the same seeded input, on the CPU (the port's STFT: `torch.fft`):

- every design array byte-identical (`np.array_equal`, same dtype): mel
  filterbanks (Slaney and HTK, both norms), the DCT-II, the chroma
  filterbank, the mel scale conversions, the contrast band slices;
- every extractor within 1e-5 of the largest |value| of the reference's
  output (the two FFTs and the products' summation orders differ by a few
  ulps; measured at most 2.4e-6), except `spectral_rolloff` and
  `zero_crossing_rate`, equal value for value, and
  `instantaneous_frequency` on a tone within 1e-5 of it (on noise the
  analytic phase of near-zero samples amplifies any ulp).
"""

import numpy as np
import pytest
import scipy.fft
import scipy.signal
import torch

import jax.numpy as jnp

from crlot_tpu import features as ref
from crlot_tpu.core.types import StftConfig as RefConfig
from crlot_tpu.pipeline import stft as ref_stft

import crlot_tpu_torch.features as F
from crlot_tpu_torch.core.types import StftConfig
from crlot_tpu_torch.features import (
    _dct_ii_ortho,
    hz_to_mel,
    mel_filterbank,
    mel_spectrogram,
    mel_to_hz,
    mfcc,
    power_to_db,
    spectral_bandwidth,
    spectral_centroid,
    spectral_flatness,
    spectral_rolloff,
)
from crlot_tpu_torch.pipeline import stft

SR = 48000
CFG = StftConfig(frame_size=1024, hop_size=256, center=True)
REF_CFG = RefConfig(frame_size=1024, hop_size=256, center=True)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone(freq, seconds=0.5, sr=SR):
    t = np.arange(int(seconds * sr)) / sr
    return np.sin(2 * np.pi * freq * t).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# mel scale
# ---------------------------------------------------------------------------

def test_htk_mel_1khz():
    assert abs(hz_to_mel(1000.0, htk=True) - 1000.0) < 0.1


def test_slaney_mel_linear_below_1khz():
    assert abs(hz_to_mel(500.0) - 500.0 * 3.0 / 200.0) < 1e-9


@pytest.mark.parametrize("htk", [False, True])
def test_mel_hz_roundtrip(htk):
    f = np.linspace(0.0, SR / 2, 777)
    back = mel_to_hz(hz_to_mel(f, htk), htk)
    np.testing.assert_allclose(back, f, rtol=1e-12, atol=1e-9)
    assert np.array_equal(hz_to_mel(f, htk), ref.hz_to_mel(f, htk))
    assert np.array_equal(back, ref.mel_to_hz(ref.hz_to_mel(f, htk), htk))


# ---------------------------------------------------------------------------
# filterbank
# ---------------------------------------------------------------------------

def _oracle_fb(sr, n_fft, n_mels, fmin, fmax, htk, norm):
    """Brute per-bin triangle evaluation (piecewise linear in Hz per bin,
    explicit loops)."""
    pts = mel_to_hz(
        np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2),
        htk,
    )
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((n_mels, len(freqs)))
    for m in range(n_mels):
        lo, mid, hi = pts[m], pts[m + 1], pts[m + 2]
        for k, f in enumerate(freqs):
            if lo < f < mid:
                fb[m, k] = (f - lo) / (mid - lo)
            elif mid <= f < hi:
                fb[m, k] = (hi - f) / (hi - mid)
            elif f == mid:
                fb[m, k] = 1.0
        if norm == "slaney":
            fb[m] *= 2.0 / (hi - lo)
    return fb.astype(np.float32)


@pytest.mark.parametrize("htk,norm", [(False, "slaney"), (True, None)])
def test_filterbank_vs_bruteforce_oracle(htk, norm):
    got = mel_filterbank(SR, 512, n_mels=24, fmin=50.0, fmax=20000.0,
                         htk=htk, norm=norm)
    want = _oracle_fb(SR, 512, 24, 50.0, 20000.0, htk, norm)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_filterbank_shape_dtype_cache():
    fb = mel_filterbank(SR, 1024, n_mels=64)
    assert fb.shape == (64, 513)
    assert fb.dtype == np.float32
    assert np.all(fb >= 0)
    assert mel_filterbank(SR, 1024, n_mels=64) is fb  # cached object
    assert not fb.flags.writeable


def test_filterbank_unit_peak_when_unnormalized():
    fb = mel_filterbank(SR, 4096, n_mels=16, norm=None)
    peaks = fb.max(axis=1)
    assert np.all(peaks > 0.9) and np.all(peaks <= 1.0 + 1e-6)


def test_filterbank_slaney_unit_area():
    fb = mel_filterbank(SR, 4096, n_mels=16, fmin=100.0, norm="slaney")
    areas = fb.sum(axis=1) * (SR / 4096)
    np.testing.assert_allclose(areas, 1.0, rtol=0.05)


def test_filterbank_validation():
    with pytest.raises(ValueError):
        mel_filterbank(SR, 1024, n_mels=0)
    with pytest.raises(ValueError):
        mel_filterbank(SR, 1024, fmin=-1.0)
    with pytest.raises(ValueError):
        mel_filterbank(SR, 1024, fmin=1000.0, fmax=500.0)
    with pytest.raises(ValueError):
        mel_filterbank(SR, 1024, norm="l2")


# ---------------------------------------------------------------------------
# mel spectrogram
# ---------------------------------------------------------------------------

def test_mel_spectrogram_is_power_matmul():
    x = np.random.default_rng(0).standard_normal(SR // 4).astype(np.float32)
    got = _np(mel_spectrogram(x, CFG, SR, n_mels=40, device=CPU))
    spec = _np(stft(x, CFG, device=CPU))
    want = (np.abs(spec) ** 2) @ mel_filterbank(SR, CFG.frame_size, 40).T
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_mel_spectrogram_tone_band():
    freq = 2000.0
    m = _np(mel_spectrogram(_tone(freq), CFG, SR, n_mels=64, device=CPU))
    band = int(np.argmax(m.mean(axis=0)))
    centers = mel_to_hz(
        np.linspace(hz_to_mel(0.0), hz_to_mel(SR / 2), 66), False
    )[1:-1]
    assert abs(centers[band] - freq) < 250.0


def test_mel_spectrogram_batched():
    x = np.random.default_rng(1).standard_normal((3, SR // 8))
    m = mel_spectrogram(x.astype(np.float32), CFG, SR, n_mels=32, device=CPU)
    assert m.shape[:1] == (3,) and m.shape[-1] == 32
    one = mel_spectrogram(x[1].astype(np.float32), CFG, SR, n_mels=32,
                          device=CPU)
    np.testing.assert_allclose(_np(m[1]), _np(one), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# MFCC
# ---------------------------------------------------------------------------

def test_dct_matrix_orthonormal():
    d = np.asarray(_dct_ii_ortho(32, 32), dtype=np.float64)
    np.testing.assert_allclose(d @ d.T, np.eye(32), atol=1e-6)


def test_mfcc_matches_scipy_dct_of_logmel():
    x = np.random.default_rng(2).standard_normal(SR // 4).astype(np.float32)
    got = _np(mfcc(x, CFG, SR, n_mfcc=13, n_mels=40, device=CPU))
    logmel = _np(power_to_db(mel_spectrogram(x, CFG, SR, n_mels=40,
                                             device=CPU))).astype(np.float64)
    want = scipy.fft.dct(logmel, type=2, norm="ortho", axis=-1)[..., :13]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


def test_mfcc_constant_logmel_energy_in_c0():
    d = np.asarray(_dct_ii_ortho(13, 40), dtype=np.float64)
    out = d @ np.ones(40)
    assert abs(out[0] - np.sqrt(40)) < 1e-5
    np.testing.assert_allclose(out[1:], 0.0, atol=1e-5)


def test_mfcc_validation():
    with pytest.raises(ValueError):
        mfcc(np.zeros(4096, np.float32), CFG, SR, n_mfcc=20, n_mels=13,
             device=CPU)


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------

def test_centroid_of_tone():
    freq = 3000.0
    c = _np(spectral_centroid(_tone(freq), CFG, SR, device=CPU))
    assert np.all(np.abs(c[4:-4] - freq) < 2 * SR / CFG.frame_size)


def test_centroid_silent_is_zero_not_nan():
    c = _np(spectral_centroid(np.zeros(8192, np.float32), CFG, SR,
                              device=CPU))
    assert np.all(np.isfinite(c)) and np.all(c == 0.0)


def test_bandwidth_tone_vs_noise():
    bw_tone = _np(spectral_bandwidth(_tone(3000.0), CFG, SR,
                                     device=CPU))[4:-4]
    noise = np.random.default_rng(3).standard_normal(SR // 2).astype(
        np.float32)
    bw_noise = _np(spectral_bandwidth(noise, CFG, SR, device=CPU))[4:-4]
    assert np.all(bw_tone < 500.0)
    assert np.all(bw_noise > 3000.0)


def test_rolloff_tone():
    freq = 3000.0
    r = _np(spectral_rolloff(_tone(freq), CFG, SR, device=CPU))[4:-4]
    assert np.all(np.abs(r - freq) < 3 * SR / CFG.frame_size)


def test_rolloff_monotonic_in_percent():
    x = np.random.default_rng(4).standard_normal(SR // 2).astype(np.float32)
    r50 = _np(spectral_rolloff(x, CFG, SR, roll_percent=0.5, device=CPU))
    r95 = _np(spectral_rolloff(x, CFG, SR, roll_percent=0.95, device=CPU))
    assert np.all(r95 >= r50)


def test_flatness_tone_vs_noise():
    flat_tone = _np(spectral_flatness(_tone(3000.0), CFG, device=CPU))[4:-4]
    noise = np.random.default_rng(5).standard_normal(SR // 2).astype(
        np.float32)
    flat_noise = _np(spectral_flatness(noise, CFG, device=CPU))[4:-4]
    assert np.all(flat_tone < 0.05)
    assert np.all(flat_noise > 0.3) and np.all(flat_noise < 0.9)


# ---------------------------------------------------------------------------
# LPC
# ---------------------------------------------------------------------------

def _lpc_oracle(frame, order):
    """Solve the autocorrelation normal equations directly (f64)."""
    t = len(frame)
    r = np.array([np.dot(frame[: t - k], frame[k:])
                  for k in range(order + 1)])
    R = np.array([[r[abs(i - j)] for j in range(order)]
                  for i in range(order)])
    a = np.linalg.solve(R, -r[1 : order + 1])
    return np.concatenate([[1.0], a])


@pytest.mark.parametrize("order", [4, 12])
def test_lpc_matches_normal_equation_oracle(order):
    from crlot_tpu_torch.features import lpc
    from crlot_tpu_torch.frame.framing import frame_signal
    from crlot_tpu_torch.window.windows import get_window

    x = np.random.default_rng(10).standard_normal(SR // 8).astype(np.float32)
    got = _np(lpc(x, CFG, order=order, device=CPU))
    frames = _np(frame_signal(torch.from_numpy(x), CFG.frame_spec)).astype(
        np.float64)
    w = np.asarray(get_window(CFG.window, CFG.frame_size, CFG.periodic))
    for i in range(4, frames.shape[0] - 4, 7):
        want = _lpc_oracle(frames[i] * w, order)
        np.testing.assert_allclose(got[i], want, rtol=5e-3, atol=5e-4)


def test_lpc_recovers_ar_process():
    from crlot_tpu_torch.features import lpc
    from crlot_tpu_torch.iir import lfilter

    a_true = np.array([1.0, -1.2, 0.8, -0.1])
    e = np.random.default_rng(11).standard_normal(SR // 2).astype(np.float32)
    x = lfilter([1.0], a_true, e, device=CPU)
    got = _np(lpc(x, CFG, order=3))
    np.testing.assert_allclose(np.median(got[4:-4], axis=0), a_true,
                               atol=0.05)


def test_lpc_silence_is_finite():
    from crlot_tpu_torch.features import lpc

    a = _np(lpc(np.zeros(8192, np.float32), CFG, order=8, device=CPU))
    assert np.all(np.isfinite(a))
    np.testing.assert_allclose(a[..., 0], 1.0)


def test_lpc_validation():
    from crlot_tpu_torch.features import lpc

    with pytest.raises(ValueError):
        lpc(np.zeros(4096, np.float32), CFG, order=0, device=CPU)
    with pytest.raises(ValueError):
        lpc(np.zeros(4096, np.float32), CFG, order=CFG.frame_size,
            device=CPU)


def test_lpc_envelope_matches_direct_eval():
    from crlot_tpu_torch.features import lpc_envelope_db

    a = np.array([1.0, -1.2, 0.8, -0.1], np.float32)
    got = _np(lpc_envelope_db(a, 512, device=CPU))
    w = 2 * np.pi * np.arange(257) / 512
    A = sum(a[k] * np.exp(-1j * w * k) for k in range(4))
    np.testing.assert_allclose(got, -20 * np.log10(np.abs(A)), atol=2e-3)


def test_lpc_envelope_tracks_ar_resonance():
    from crlot_tpu_torch.features import lpc, lpc_envelope_db
    from crlot_tpu_torch.iir import lfilter

    f0, r = 3000.0, 0.97
    a_true = [1.0, -2 * r * np.cos(2 * np.pi * f0 / SR), r * r]
    e = np.random.default_rng(12).standard_normal(SR // 2).astype(np.float32)
    x = lfilter([1.0], a_true, e, device=CPU)
    a_hat = _np(lpc(x, CFG, order=2))
    env = _np(lpc_envelope_db(np.median(a_hat[4:-4], axis=0),
                              CFG.frame_size, device=CPU))
    assert abs(np.argmax(env) * SR / CFG.frame_size - f0) < 150.0


def test_real_cepstrum_echo_peak():
    from crlot_tpu_torch.features import real_cepstrum

    x = np.random.default_rng(13).standard_normal(SR // 2).astype(np.float32)
    d = 160
    y = x.copy()
    y[d:] += 0.5 * x[:-d]
    c = _np(real_cepstrum(y, CFG, device=CPU)).mean(axis=0)
    band = c[32 : CFG.frame_size // 2]
    assert abs((np.argmax(band) + 32) - d) <= 2


def test_real_cepstrum_oracle():
    from crlot_tpu_torch.features import real_cepstrum

    x = np.random.default_rng(14).standard_normal(SR // 8).astype(np.float32)
    got = _np(real_cepstrum(x, CFG, device=CPU))
    spec = _np(stft(x, CFG, device=CPU))
    want = np.fft.irfft(np.log(np.maximum(np.abs(spec), 1e-10)),
                        n=CFG.frame_size, axis=-1)
    np.testing.assert_allclose(got, want, atol=2e-4)


# ---------------------------------------------------------------------------
# inversion: mfcc_to_mel / mel_to_linear / mel_to_audio
# ---------------------------------------------------------------------------

def test_mfcc_to_mel_full_coeffs_exact():
    from crlot_tpu_torch.features import mfcc_to_mel

    x = np.random.default_rng(6).standard_normal(SR // 4).astype(np.float32)
    logmel = _np(power_to_db(mel_spectrogram(x, CFG, SR, n_mels=32,
                                             device=CPU)))
    c = mfcc(x, CFG, SR, n_mfcc=32, n_mels=32, device=CPU)
    back = _np(mfcc_to_mel(c, n_mels=32))
    np.testing.assert_allclose(back, 10.0 ** (logmel / 10.0), rtol=2e-3,
                               atol=1e-7)


def test_mfcc_to_mel_truncated_is_smoothed():
    from crlot_tpu_torch.features import mfcc_to_mel

    x = np.random.default_rng(7).standard_normal(SR // 4).astype(np.float32)
    c = mfcc(x, CFG, SR, n_mfcc=13, n_mels=40, device=CPU)
    back = _np(mfcc_to_mel(c, n_mels=40))
    assert back.shape[-1] == 40 and np.all(back >= 0)
    with pytest.raises(ValueError):
        mfcc_to_mel(c, n_mels=8)


def test_mel_to_linear_nnls_residual():
    from crlot_tpu_torch.features import mel_to_linear

    x = np.random.default_rng(8).standard_normal(SR // 4).astype(np.float32)
    mel = _np(mel_spectrogram(x, CFG, SR, n_mels=64, device=CPU))
    lin = _np(mel_to_linear(mel, SR, CFG.frame_size, n_mels=64, iters=64,
                            device=CPU))
    assert np.all(lin >= 0)
    fb = mel_filterbank(SR, CFG.frame_size, 64)
    assert np.linalg.norm(lin @ fb.T - mel) / np.linalg.norm(mel) < 0.02


def test_mel_to_audio_recovers_tone_pitch():
    from crlot_tpu_torch.features import mel_to_audio

    freq = 1500.0
    x = _tone(freq, seconds=0.35)
    mel = mel_spectrogram(x, CFG, SR, n_mels=128, device=CPU)
    y = _np(mel_to_audio(mel, CFG, SR, n_mels=128, gl_iters=16,
                         length=len(x)))
    assert y.shape == x.shape and np.all(np.isfinite(y))
    spec = np.abs(np.fft.rfft(y[SR // 8 : SR // 4] * np.hanning(SR // 8)))
    assert abs(np.argmax(spec) * SR / (SR // 8) - freq) < 60.0


def test_envelope_matches_scipy_hilbert():
    from crlot_tpu_torch.features import envelope

    x = _tone(440.0, seconds=0.25) * np.hanning(SR // 4).astype(np.float32)
    got = _np(envelope(x, device=CPU))
    want = np.abs(scipy.signal.hilbert(x.astype(np.float64)))
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("n", [4096, 4097])  # even + odd length paths
def test_envelope_am_tone(n):
    from crlot_tpu_torch.features import envelope

    t = np.arange(n) / SR
    mod = 1.0 + 0.5 * np.sin(2 * np.pi * 13.0 * t)
    x = (mod * np.sin(2 * np.pi * 3000.0 * t)).astype(np.float32)
    env = _np(envelope(x, device=CPU))[n // 8 : -n // 8]
    assert np.max(np.abs(env - mod[n // 8 : -n // 8])) < 0.02


def test_instantaneous_frequency_of_tone():
    from crlot_tpu_torch.features import instantaneous_frequency

    freq = 2500.0
    f = _np(instantaneous_frequency(_tone(freq, seconds=0.25), float(SR),
                                    device=CPU))
    assert np.all(np.abs(f[SR // 50 : -SR // 50] - freq) < 1.0)


def test_frame_rms_of_tone():
    from crlot_tpu_torch.features import frame_rms

    r = _np(frame_rms(0.6 * _tone(997.0), CFG, device=CPU))[4:-4]
    np.testing.assert_allclose(r, 0.6 / np.sqrt(2.0), atol=2e-3)


def test_zero_crossing_rate():
    from crlot_tpu_torch.features import zero_crossing_rate

    freq = 1200.0
    z = _np(zero_crossing_rate(_tone(freq), CFG, device=CPU))[4:-4]
    np.testing.assert_allclose(z, 2.0 * freq / SR, atol=2e-3)
    const = np.ones(8192, np.float32)
    zc = _np(zero_crossing_rate(const, CFG, device=CPU))[4:-4]
    assert np.all(zc == 0.0)


def test_power_to_db_floor():
    p = torch.tensor([0.0, 1.0, 100.0])
    db = _np(power_to_db(p, floor_db=-100.0))
    np.testing.assert_allclose(db, [-100.0, 0.0, 20.0], atol=1e-4)


# ---------------------------------------------------------------------------
# chroma + delta
# ---------------------------------------------------------------------------

def test_chroma_tone_pitch_class():
    from crlot_tpu_torch.features import chroma

    c = _np(chroma(_tone(440.0), CFG, SR, device=CPU)).mean(axis=0)
    assert int(np.argmax(c)) == 9
    c2 = _np(chroma(_tone(659.26), CFG, SR, device=CPU)).mean(axis=0)
    assert int(np.argmax(c2)) == 4


def test_chroma_octave_invariance():
    from crlot_tpu_torch.features import chroma

    cfg = StftConfig(frame_size=4096, hop_size=1024, center=True)
    for f in (220.0, 440.0, 880.0):
        c = _np(chroma(_tone(f), cfg, SR, device=CPU)).mean(axis=0)
        assert int(np.argmax(c)) == 9, f


def test_chroma_filterbank_shape_and_energy_distribution():
    from crlot_tpu_torch.features import chroma_filterbank

    fb = chroma_filterbank(SR, 1024)
    assert fb.shape == (12, 513) and fb.dtype == np.float32
    col = fb.sum(axis=0)
    freqs = np.fft.rfftfreq(1024, 1.0 / SR)
    np.testing.assert_allclose(col[freqs >= 32.0], 1.0, atol=1e-5)
    assert np.all(col[freqs < 32.0] == 0.0)


def test_delta_of_linear_ramp_is_slope():
    from crlot_tpu_torch.features import delta

    f, dim, slope = 40, 5, 0.37
    feat = (slope * np.arange(f))[:, None] * np.ones((1, dim))
    d = _np(delta(feat.astype(np.float32), width=9, device=CPU))
    np.testing.assert_allclose(d[4:-4], slope, rtol=1e-4)


def test_delta_matches_direct_oracle():
    from crlot_tpu_torch.features import delta

    feat = np.random.default_rng(15).standard_normal((30, 4)).astype(
        np.float32)
    width, half = 5, 2
    got = _np(delta(feat, width=width, device=CPU))
    dd = np.arange(-half, half + 1)
    padded = np.pad(feat, ((half, half), (0, 0)), mode="edge")
    want = np.stack(
        [sum(d * padded[t + d + half] for d in dd) / np.sum(dd * dd)
         for t in range(feat.shape[0])]
    )
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_delta_validation_and_order2():
    from crlot_tpu_torch.features import delta

    feat = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError):
        delta(feat, width=4, device=CPU)
    with pytest.raises(ValueError):
        delta(feat, order=0, device=CPU)
    assert tuple(delta(feat, order=2, device=CPU).shape) == feat.shape


# ---------------------------------------------------------------------------
# dB conversions + magphase
# ---------------------------------------------------------------------------

def test_db_conversions_roundtrip():
    from crlot_tpu_torch.features import (
        amplitude_to_db,
        db_to_amplitude,
        db_to_power,
    )

    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.uniform(1e-6, 10.0, 64).astype(np.float32))
    np.testing.assert_allclose(_np(db_to_power(power_to_db(p))), _np(p),
                               rtol=1e-5)
    a = torch.sqrt(p)
    np.testing.assert_allclose(_np(db_to_amplitude(amplitude_to_db(a))),
                               _np(a), rtol=1e-5)
    np.testing.assert_allclose(_np(amplitude_to_db(a)), _np(power_to_db(p)),
                               atol=1e-4)
    assert float(power_to_db(torch.zeros(1))[0]) == -100.0
    assert float(amplitude_to_db(torch.zeros(1))[0]) == -100.0


def test_magphase_reconstructs():
    from crlot_tpu_torch.features import magphase

    rng = np.random.default_rng(4)
    spec = (rng.standard_normal((5, 9))
            + 1j * rng.standard_normal((5, 9))).astype(np.complex64)
    spec[0, 0] = 0.0  # zero bin: phasor must be 1, not NaN
    mag, ph = magphase(torch.from_numpy(spec))
    np.testing.assert_allclose(_np(mag * ph), spec, atol=1e-6)
    np.testing.assert_allclose(np.abs(_np(ph)), 1.0, atol=1e-6)
    assert _np(ph)[0, 0] == 1.0


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (SR, 1024, 64, 0.0, None, False, "slaney"),
    (SR, 512, 24, 50.0, 20000.0, True, None),
    (16000.0, 4096, 128, 20.0, 7600.0, False, None),
])
def test_design_arrays_byte_identical(args):
    pairs = [
        (mel_filterbank(*args), ref.mel_filterbank(*args)),
        (_dct_ii_ortho(13, args[2]), ref._dct_ii_ortho(13, args[2])),
        (F.chroma_filterbank(args[0], args[1]),
         ref.chroma_filterbank(args[0], args[1])),
        (F.chroma_filterbank(args[0], args[1], 24, 0.5, 50.0),
         ref.chroma_filterbank(args[0], args[1], 24, 0.5, 50.0)),
    ]
    for got, want in pairs:
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape and np.array_equal(got, want)
    assert (F._contrast_band_slices(args[0], args[1], 4, 200.0)
            == ref._contrast_band_slices(args[0], args[1], 4, 200.0))


def test_device_copies_are_cached_per_device():
    fb = mel_filterbank(SR, 1024, 40)
    key = F._melfb_key(SR, 1024, 40, 0.0, None, False, "slaney")
    a = F._on(key, fb, torch.device("cpu"), transpose=True)
    assert F._on(key, fb, torch.device("cpu"), transpose=True) is a
    assert a.is_contiguous() and torch.equal(a, torch.from_numpy(fb.T.copy()))
    assert (key + ("cpu", True)) in F._DEV_CACHE


def _noise2(seed, n=SR // 4):
    return np.random.default_rng(seed).uniform(-1, 1, (2, n)).astype(
        np.float32)


def _close(got, want, rel=1e-5):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got.astype(np.complex128 if np.iscomplexobj(got)
                            else np.float64) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


EXTRACTORS = {
    "mel_spectrogram": lambda m, c, x: m.mel_spectrogram(x, c, SR, n_mels=40),
    "mel_spectrogram_htk": lambda m, c, x: m.mel_spectrogram(
        x, c, SR, 32, 30.0, 16000.0, True, None),
    "mfcc": lambda m, c, x: m.mfcc(x, c, SR, n_mfcc=20, n_mels=40),
    "spectral_centroid": lambda m, c, x: m.spectral_centroid(x, c, SR),
    "spectral_bandwidth": lambda m, c, x: m.spectral_bandwidth(x, c, SR),
    "spectral_flatness": lambda m, c, x: m.spectral_flatness(x, c),
    "spectral_contrast": lambda m, c, x: m.spectral_contrast(x, c, SR),
    "spectral_contrast_linear": lambda m, c, x: m.spectral_contrast(
        x, c, SR, 4, 300.0, 0.1, True),
    "chroma": lambda m, c, x: m.chroma(x, c, SR),
    "tonnetz": lambda m, c, x: m.tonnetz(x, c, SR),
    "lpc": lambda m, c, x: m.lpc(x, c, order=12),
    "real_cepstrum": lambda m, c, x: m.real_cepstrum(x, c),
    "frame_rms": lambda m, c, x: m.frame_rms(x, c),
    "envelope": lambda m, c, x: m.envelope(x),
}


@pytest.mark.parametrize("name", sorted(EXTRACTORS))
def test_extractor_matches_reference(name):
    x = _noise2(30)
    fn = EXTRACTORS[name]
    _close(fn(F, CFG, torch.from_numpy(x)), fn(ref, REF_CFG, x))


@pytest.mark.parametrize("name", ["spectral_rolloff", "zero_crossing_rate"])
def test_discrete_extractors_equal_reference(name):
    x = _noise2(31)
    if name == "spectral_rolloff":
        got = F.spectral_rolloff(x, CFG, SR, device=CPU)
        want = ref.spectral_rolloff(x, REF_CFG, SR)
    else:
        got = F.zero_crossing_rate(x, CFG, device=CPU)
        want = ref.zero_crossing_rate(x, REF_CFG)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_instantaneous_frequency_matches_reference_on_a_tone():
    x = np.stack([_tone(2500.0, 0.1), 0.5 * _tone(700.0, 0.1)])
    _close(F.instantaneous_frequency(x, float(SR), device=CPU),
           ref.instantaneous_frequency(x, float(SR)))


def test_inversion_and_helpers_match_reference():
    x = _noise2(32)
    mel = np.asarray(ref.mel_spectrogram(x, REF_CFG, SR, n_mels=40))
    _close(F.mel_to_linear(mel, SR, 1024, n_mels=40, iters=8, device=CPU),
           ref.mel_to_linear(mel, SR, 1024, n_mels=40, iters=8))
    c = np.asarray(ref.mfcc(x, REF_CFG, SR, n_mfcc=13, n_mels=40))
    _close(F.mfcc_to_mel(c, n_mels=40, device=CPU),
           ref.mfcc_to_mel(c, n_mels=40))
    _close(F.delta(mel, width=5, order=2, device=CPU),
           ref.delta(mel, width=5, order=2))
    a = np.array([1.0, -1.2, 0.8, -0.1], np.float32)
    _close(F.lpc_envelope_db(a, 512, device=CPU), ref.lpc_envelope_db(a, 512))
    for f_port, f_ref in ((F.power_to_db, ref.power_to_db),
                          (F.amplitude_to_db, ref.amplitude_to_db)):
        _close(f_port(mel, -80.0, 2.0, device=CPU), f_ref(mel, -80.0, 2.0))
    db = np.asarray(ref.power_to_db(mel))
    _close(F.db_to_power(db, device=CPU), ref.db_to_power(db))
    _close(F.db_to_amplitude(db, device=CPU), ref.db_to_amplitude(db))
    spec = np.asarray(ref_stft(jnp.asarray(x), REF_CFG))
    mag, ph = F.magphase(spec, device=CPU)
    rmag, rph = ref.magphase(jnp.asarray(spec))
    _close(mag, rmag)
    _close(ph, rph)


def test_mel_to_audio_is_nnls_then_griffin_lim():
    """mel_to_audio composes mel_to_linear and griffin_lim (seed 0)."""
    from crlot_tpu_torch.griffinlim import griffin_lim

    cfg = StftConfig(frame_size=512, hop_size=128, center=True,
                     synthesis_window=True)
    x = torch.from_numpy(_tone(1000.0, 0.05))
    mel = F.mel_spectrogram(x, cfg, SR, n_mels=32)
    got = F.mel_to_audio(mel, cfg, SR, n_mels=32, nnls_iters=4, gl_iters=3)
    lin = F.mel_to_linear(mel, SR, 512, n_mels=32, iters=4)
    want = griffin_lim(torch.sqrt(torch.clamp_min(lin, 0.0)), cfg, iters=3)
    assert torch.equal(got, want)


def test_products_on_the_card_go_to_the_fixed_order_kernel(monkeypatch):
    """On a non-CPU tensor every filterbank product launches B0's fp32
    kernel (no cuBLAS), with K and N zero-padded to multiples of 4 and the
    output cropped back; on the CPU it is `torch.matmul`."""
    from crlot_tpu_torch.fft import fp32_window

    seen = []

    def fake(a, b):
        seen.append((tuple(a.shape), tuple(b.shape)))
        return torch.empty(a.shape[:-1] + (b.shape[1],), device=a.device)

    monkeypatch.setattr(fp32_window, "gemm_cuda", fake)
    a = torch.empty((2, 7, 513), device="meta")
    out = F._product(a, torch.empty((513, 12), device="meta"))
    assert seen == [((2, 7, 516), (516, 12))] and tuple(out.shape) == (2, 7, 12)
    out = F._product(torch.empty((5, 12), device="meta"),
                     torch.empty((12, 6), device="meta"))
    assert seen[-1] == ((5, 12), (12, 8)) and tuple(out.shape) == (5, 6)
    x = torch.rand((3, 513))
    fb = torch.rand((513, 12))
    assert torch.equal(F._product(x, fb), torch.matmul(x, fb))


def test_zero_padding_adds_nothing_to_the_kernels_chain():
    """B0 fp32's chain (emulated exactly) over the zero-padded operands
    equals the chain over the operands as they are."""
    from crlot_tpu_torch.fft import fp32_window

    rng = np.random.default_rng(50)
    a = torch.from_numpy(rng.standard_normal((9, 13)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((13, 6)).astype(np.float32))
    pa = torch.nn.functional.pad(a, (0, 3))
    pb = torch.nn.functional.pad(b, (0, 2, 0, 3))
    assert torch.equal(fp32_window.chain_plain(pa, pb)[:, :6],
                       fp32_window.chain_plain(a, b))


@pytest.mark.parametrize("shards", [2, 4])
def test_per_frame_sums_do_not_depend_on_the_row_count(shards):
    """`_sum_last` (the descriptors' sums) gives each row the same bits
    alone and among others: the pairwise order is fixed."""
    x = torch.from_numpy(np.random.default_rng(51).standard_normal(
        (shards * 3, 513)).astype(np.float32))
    whole = F._sum_last(x)
    parts = torch.cat([F._sum_last(p) for p in x.split(3)])
    assert torch.equal(whole, parts)
    np.testing.assert_allclose(whole.numpy(), x.double().sum(-1).numpy(),
                               rtol=1e-5)
