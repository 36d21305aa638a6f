"""The port's YIN, onset, tempogram and tempo (`crlot_tpu_torch.pitch`) on
the CPU, and the spectral contrast they sit beside in the reference's
rhythm tests.

Mirrors `tests/test_pitch.py` and `tests/test_rhythm.py` case for case with
their gates (tones within 1 % after YIN, noise unvoiced, clicks found
within a frame and no extra onsets, click-train tempi within 5 %, the
tempogram's peak within 2 lags of the period, the contrast gates), then
holds the port against the reference on the same seeded input: every
output within 1e-5 of the largest |value| of the reference's, and the
onset masks equal. The two packages' FFTs (`torch.fft`, `jnp.fft`) and
cumsums sum in other orders: XLA's CPU cumsum is a reduce-window that XLA
rewrites into its own blocked order, neither sequential nor
`torch.cumsum`'s, so YIN's running energies differ by ulps (measured: f0
within 1.2e-6 of the largest, aperiodicity 4e-7). The onset signals carry
a noise floor 40 dB down, as recorded audio does (envelopes measured
within 2e-7 of the largest): on pure tones the dB of a mel band 100 dB
below the tone turns the STFTs' roundoff into 6e-4 dB of flux, and in
digital silence the reference's envelope holds a constant 1.4e-6 dB
residue (XLA's CPU fusion evaluates the log of each frame twice, in two
ways) where the port's is 0. The means over bands, windows and frames
are pairwise (`features._sum_last`), so eight CPU shards of the channels
are `torch.equal` to one call.
"""

import numpy as np
import pytest
import torch

from crlot_tpu import pitch as ref
from crlot_tpu.core.types import StftConfig as JConfig

from crlot_tpu_torch.core.types import StftConfig
from crlot_tpu_torch.features import _contrast_band_slices, spectral_contrast
from crlot_tpu_torch.pitch import (
    detect_onsets,
    onset_strength,
    tempo,
    tempogram,
    yin_f0,
)

SR = 48000
CFG = StftConfig(frame_size=2048, hop_size=512, center=False)
JCFG = JConfig(frame_size=2048, hop_size=512, center=False)
RCFG = StftConfig(frame_size=1024, hop_size=256, center=True)
JRCFG = JConfig(frame_size=1024, hop_size=256, center=True)
CPU = "cpu"
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone(freq, seconds=0.4, sr=SR, amp=0.8):
    t = np.arange(int(seconds * sr)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))


# ---------------------------------------------------------------------------
# mirrors of tests/test_pitch.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("freq", [110.0, 220.0, 440.0, 1000.0])
def test_yin_pure_tone(freq):
    f0, ap = (_np(v) for v in yin_f0(_tone(freq), CFG, float(SR),
                                      device=CPU))
    interior = f0[2:-2]
    assert np.all(np.abs(interior - freq) / freq < 0.01), interior
    assert np.all(ap[2:-2] < 0.05)


def test_yin_harmonic_series_no_octave_error():
    f0_true = 150.0
    t = np.arange(SR // 2) / SR
    x = sum(
        (0.6 / k) * np.sin(2 * np.pi * f0_true * k * t) for k in range(1, 7)
    ).astype(np.float32)
    f0, _ = yin_f0(x, CFG, float(SR), device=CPU)
    interior = _np(f0)[2:-2]
    assert np.all(np.abs(interior - f0_true) / f0_true < 0.01), interior


def test_yin_noise_is_unvoiced():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(SR // 2).astype(np.float32)
    f0, ap = (_np(v) for v in yin_f0(x, CFG, float(SR), device=CPU))
    assert np.median(ap) > 0.3
    assert np.mean(f0 == 0.0) > 0.5


def test_yin_silence():
    f0, ap = (_np(v) for v in yin_f0(np.zeros(SR // 2, np.float32), CFG,
                                      float(SR), device=CPU))
    assert np.all(np.isfinite(f0)) and np.all(np.isfinite(ap))


def test_yin_batched():
    x = np.stack([_tone(220.0, 0.25), _tone(440.0, 0.25)])
    f0 = _np(yin_f0(x, CFG, float(SR), device=CPU)[0])
    assert abs(np.median(f0[0]) - 220.0) < 3.0
    assert abs(np.median(f0[1]) - 440.0) < 5.0


def test_yin_validation():
    with pytest.raises(ValueError):
        yin_f0(_tone(440.0), CFG, float(SR), fmin=1000.0, fmax=900.0,
               device=CPU)


def _click_train(positions, total, sr=SR, width=64):
    x = np.zeros(total, np.float32)
    rng = np.random.default_rng(1)
    for p in positions:
        x[p : p + width] += rng.standard_normal(width).astype(np.float32)
    return x


def test_onset_strength_peaks_at_clicks():
    hop = CFG.hop_size
    entry = CFG.frame_size // hop - 1
    clicks = [hop * 20, hop * 50, hop * 80]
    x = _click_train(clicks, hop * 110)
    env = _np(onset_strength(x, CFG, float(SR), device=CPU))
    for p in clicks:
        frame = p // hop - entry
        window = env[max(frame - 1, 0) : frame + 2]
        assert window.max() > 3 * np.median(env), (frame, window.max())


def test_detect_onsets_finds_clicks_and_not_steady_tone():
    hop = CFG.hop_size
    clicks = [hop * 20, hop * 50, hop * 80]
    x = _click_train(clicks, hop * 110)
    mask, env = detect_onsets(x, CFG, float(SR), device=CPU)
    idx = np.nonzero(_np(mask))[0]
    entry = CFG.frame_size // hop - 1
    for p in clicks:
        want = p // hop - entry
        assert np.any(np.abs(idx - want) <= 1), (want, idx)
    assert len(idx) == len(clicks)
    tone = _tone(440.0, seconds=hop * 110 / SR)
    mask_t, _ = detect_onsets(tone, CFG, float(SR), device=CPU)
    assert _np(mask_t)[5:].sum() == 0


def test_detect_onsets_silence():
    mask, env = detect_onsets(np.zeros(SR // 2, np.float32), CFG, float(SR),
                              device=CPU)
    assert _np(mask).sum() == 0
    assert np.all(_np(env) < 1e-4)


# ---------------------------------------------------------------------------
# mirrors of tests/test_rhythm.py
# ---------------------------------------------------------------------------

def _rtone(freq, seconds=0.5, sr=SR):
    t = np.arange(int(seconds * sr)) / sr
    return np.sin(2 * np.pi * freq * t).astype(np.float32)


def _bpm_clicks(bpm, seconds=6.0, sr=SR, width=32):
    x = np.zeros(int(seconds * sr), dtype=np.float32)
    period = int(round(60.0 / bpm * sr))
    for p in range(0, len(x) - width, period):
        x[p : p + width] = 1.0
    return x


def test_contrast_bands_cover_spectrum():
    bands = _contrast_band_slices(SR, 1024, 6, 200.0)
    assert len(bands) == 7
    assert bands[0][0] == 0
    assert all(hi > lo + 1 for lo, hi in bands)
    assert bands[-1][1] <= 1024 // 2 + 1


def test_contrast_rejects_too_many_bands():
    with pytest.raises(ValueError):
        _contrast_band_slices(SR, 1024, 12, 200.0)


def test_contrast_shape():
    c = spectral_contrast(_rtone(1000.0), RCFG, SR, device=CPU)
    assert c.shape[-1] == 7
    assert c.ndim == 2


def test_tone_has_high_contrast_in_its_band():
    c = _np(spectral_contrast(_rtone(1000.0), RCFG, SR, device=CPU))
    bands = _contrast_band_slices(SR, 1024, 6, 200.0)
    freqs = np.fft.rfftfreq(1024, 1.0 / SR)
    band_idx = next(
        i for i, (lo, hi) in enumerate(bands)
        if freqs[lo] <= 1000.0 < freqs[hi - 1] + (freqs[1] - freqs[0])
    )
    assert c[c.shape[0] // 2][band_idx] > 30.0


def test_noise_has_low_contrast():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(SR // 2).astype(np.float32)
    c = _np(spectral_contrast(x, RCFG, SR, device=CPU))
    assert float(np.median(c)) < 25.0


def test_tone_beats_noise_contrast():
    rng = np.random.default_rng(6)
    noise = rng.standard_normal(SR // 2).astype(np.float32)
    ct = _np(spectral_contrast(_rtone(1000.0), RCFG, SR, device=CPU))
    cn = _np(spectral_contrast(noise, RCFG, SR, device=CPU))
    assert np.max(np.median(ct, axis=0)) > np.max(np.median(cn, axis=0))


def test_contrast_linear_matches_db():
    x = _rtone(500.0, seconds=0.25)
    db = _np(spectral_contrast(x, RCFG, SR, device=CPU))
    lin = _np(spectral_contrast(x, RCFG, SR, linear=True, device=CPU))
    np.testing.assert_allclose(
        10.0 * np.log10(np.maximum(lin, 1e-12)), db, atol=0.5
    )


def test_contrast_rejects_bad_quantile():
    with pytest.raises(ValueError):
        spectral_contrast(_rtone(500.0, seconds=0.1), RCFG, SR, quantile=0.9,
                          device=CPU)


@pytest.mark.parametrize("bpm", [90.0, 120.0, 150.0])
def test_click_train_tempo(bpm):
    got = float(tempo(_bpm_clicks(bpm), RCFG, SR, device=CPU))
    assert abs(got - bpm) / bpm < 0.05, got


def test_silence_tempo_is_zero():
    assert float(tempo(np.zeros(SR, np.float32), RCFG, SR, device=CPU)) == 0.0


def test_tempo_batched():
    x = np.stack([_bpm_clicks(90.0), _bpm_clicks(150.0)])
    got = _np(tempo(x, RCFG, SR, device=CPU))
    assert abs(got[0] - 90.0) < 5.0 and abs(got[1] - 150.0) < 8.0


def test_tempogram_peak_at_period():
    bpm = 120.0
    tg = _np(tempogram(_bpm_clicks(bpm), RCFG, SR, win_frames=256,
                       device=CPU))
    assert tg.shape[-1] == 256
    np.testing.assert_allclose(tg[..., 0], 1.0, atol=1e-5)
    period_lag = 60.0 / bpm * SR / RCFG.hop_size
    mid = tg[tg.shape[0] // 2]
    peak = 20 + int(np.argmax(mid[20:]))
    assert abs(peak - period_lag) <= 2.0, (peak, period_lag)


def test_tempo_too_short_raises():
    with pytest.raises(ValueError, match="too short for tempo"):
        tempo(np.zeros(2048, np.float32), RCFG, SR, device=CPU)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _floor(x, seed):
    """x plus a noise floor 40 dB down (see the module docstring)."""
    rng = np.random.default_rng(seed)
    return (x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)


def _mixed(seconds=1.0, seed=30):
    """Two channels: a tone stack with clicks, and noise with a tone."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    a = 0.5 * np.sin(2 * np.pi * 196.0 * t) + 0.2 * np.sin(
        2 * np.pi * 392.0 * t)
    a[:: SR // 4] += 1.0
    b = 0.3 * rng.standard_normal(n) + 0.4 * np.sin(2 * np.pi * 523.0 * t)
    return _floor(np.stack([a, b]), seed + 1)


def test_yin_matches_reference():
    x = _mixed()
    f0, ap = yin_f0(x, CFG, float(SR), device=CPU)
    jf0, jap = ref.yin_f0(x, JCFG, float(SR))
    _close(f0, jf0)
    _close(ap, jap)
    assert np.array_equal(_np(f0) == 0, np.asarray(jf0) == 0)


@pytest.mark.parametrize("cfg,jcfg", [(CFG, JCFG), (RCFG, JRCFG)])
def test_onsets_match_reference(cfg, jcfg):
    x = _mixed(seed=31)
    _close(onset_strength(x, cfg, float(SR), device=CPU),
           ref.onset_strength(x, jcfg, float(SR)))
    mask, env = detect_onsets(x, cfg, float(SR), pre_frames=2,
                              post_frames=4, device=CPU)
    jmask, jenv = ref.detect_onsets(x, jcfg, float(SR), pre_frames=2,
                                    post_frames=4)
    assert np.array_equal(_np(mask), np.asarray(jmask))
    _close(env, jenv)


def test_tempogram_and_tempo_match_reference():
    x = _floor(np.stack([_bpm_clicks(120.0, seconds=3.0),
                         _bpm_clicks(97.0, seconds=3.0)]), 40)
    _close(tempogram(x, RCFG, SR, win_frames=128, device=CPU),
           ref.tempogram(x, JRCFG, SR, win_frames=128))
    _close(tempo(x, RCFG, SR, device=CPU), ref.tempo(x, JRCFG, SR))
    _close(tempo(x, RCFG, SR, start_bpm=90.0, std_bpm=0.5, device=CPU),
           ref.tempo(x, JRCFG, SR, start_bpm=90.0, std_bpm=0.5))


def test_sharded_pitch_bit_identical():
    from crlot_tpu_torch.distributed.mesh import make_mesh

    mesh = make_mesh(channel=8, time=1, devices=[CPU] * 8)
    x = torch.from_numpy(np.concatenate([_mixed(0.5, s) for s in range(4)]))
    calls = {
        "yin_f0": lambda z: torch.stack(yin_f0(z, CFG, float(SR))),
        "detect_onsets": lambda z: torch.stack(
            [v.float() for v in detect_onsets(z, CFG, float(SR))]),
        "tempogram": lambda z: tempogram(z, RCFG, SR, win_frames=64)[None],
        "tempo": lambda z: tempo(z, RCFG, SR)[None],
    }
    for name, fn in calls.items():
        whole = fn(x)
        parts = torch.cat([fn(x[c:c + 1].to(mesh.device(c, 0)))
                           for c in range(8)], dim=1)
        assert torch.equal(parts, whole), name
