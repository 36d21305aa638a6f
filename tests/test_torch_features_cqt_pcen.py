"""The port's pseudo-CQT, chroma_cqt, tonnetz design and PCEN on the CPU.

Mirrors `tests/test_cqt.py` (7 cases: the filterbank's rows and peaks, the
Nyquist refusal, tones in their bins, the octave shift, chroma_cqt's pitch
class) and `tests/test_pcen.py` (6 cases: the sequential-loop oracle at
rtol / atol 2e-4, gain invariance at 0.02, onset emphasis, the mel
pipeline, validation, chunked == one-shot at rtol 1e-5 / atol 1e-6), with
their gates, then holds the port against the reference on the same seeded
input:

- `cqt_filterbank` and `_tonnetz_basis` byte-identical (same dtype);
- `pseudo_cqt`, `chroma_cqt` and `pcen` within 1e-5 of the largest |value|
  of the reference's output (measured at most 3.0e-7);
- a reference `pcen` state `zf` (numpy) passed to the port as `zi`
  continues the stream as the reference's own continuation does, within
  the same 1e-5, and the port's zf within 1e-5 of the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crlot_tpu import features as ref
from crlot_tpu.core.types import StftConfig as RefConfig

from crlot_tpu_torch.core.types import StftConfig
from crlot_tpu_torch.features import (
    _tonnetz_basis,
    chroma_cqt,
    cqt_filterbank,
    mel_spectrogram,
    pcen,
    pseudo_cqt,
)

SR = 48000
CFG = StftConfig(frame_size=4096, hop_size=1024, center=True)
REF_CFG = RefConfig(frame_size=4096, hop_size=1024, center=True)
PCEN_SR = 16000
PCEN_CFG = StftConfig(frame_size=512, hop_size=128, center=True)
FRAME_RATE = PCEN_SR / PCEN_CFG.hop_size
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone(freq, seconds=0.4, sr=SR):
    t = np.arange(int(seconds * sr)) / sr
    return np.sin(2 * np.pi * freq * t).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, rel=1e-5):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# pseudo-CQT (mirrors tests/test_cqt.py)
# ---------------------------------------------------------------------------

def test_filterbank_shape_and_rows():
    fb = cqt_filterbank(SR, 4096, n_bins=84)
    assert fb.shape == (84, 4096 // 2 + 1)
    assert np.all(fb >= 0)
    np.testing.assert_allclose(fb.sum(axis=1), 1.0, atol=1e-5)


def test_filterbank_peak_at_center():
    fb = cqt_filterbank(SR, 4096, n_bins=48, fmin=110.0)
    freqs = np.fft.rfftfreq(4096, 1.0 / SR)
    centers = 110.0 * 2.0 ** (np.arange(48) / 12.0)
    got = freqs[np.argmax(fb, axis=1)]
    assert np.all(np.abs(got - centers) <= SR / 4096 + 1e-6)


def test_filterbank_rejects_above_nyquist():
    with pytest.raises(ValueError):
        cqt_filterbank(8000, 1024, n_bins=96)


def test_tone_lands_in_its_bin():
    fmin = 110.0
    for k in (12, 24, 31):
        f = fmin * 2.0 ** (k / 12.0)
        c = _np(pseudo_cqt(_tone(f), CFG, SR, n_bins=48, fmin=fmin,
                           device=CPU))
        assert int(np.argmax(c[c.shape[0] // 2])) == k


def test_octave_shift_moves_12_bins():
    fmin = 110.0
    c1 = _np(pseudo_cqt(_tone(220.0), CFG, SR, n_bins=48, fmin=fmin,
                        device=CPU))
    c2 = _np(pseudo_cqt(_tone(440.0), CFG, SR, n_bins=48, fmin=fmin,
                        device=CPU))
    b1 = int(np.argmax(c1[c1.shape[0] // 2]))
    b2 = int(np.argmax(c2[c2.shape[0] // 2]))
    assert b2 - b1 == 12


def test_batched_shape():
    x = np.stack([_tone(220.0, 0.2), _tone(440.0, 0.2)])
    c = pseudo_cqt(x, CFG, SR, n_bins=36, fmin=110.0, device=CPU)
    assert c.shape[0] == 2 and c.shape[-1] == 36


def test_chroma_cqt_pitch_class_and_octave_invariance():
    c3 = _np(chroma_cqt(_tone(220.0), CFG, SR, device=CPU))
    c4 = _np(chroma_cqt(_tone(440.0), CFG, SR, device=CPU))
    assert c3.shape[-1] == 12
    assert int(np.argmax(c3[c3.shape[0] // 2])) == 9
    assert int(np.argmax(c4[c4.shape[0] // 2])) == 9


# ---------------------------------------------------------------------------
# PCEN (mirrors tests/test_pcen.py)
# ---------------------------------------------------------------------------

def _pcen_loop(s_mat, s, gain, bias, power, eps):
    """Direct sequential reference implementation."""
    m = np.empty_like(s_mat)
    prev = s_mat[0]
    for t in range(s_mat.shape[0]):
        prev = (1 - s) * prev + s * s_mat[t]
        m[t] = prev
    return (s_mat / (eps + m) ** gain + bias) ** power - bias ** power


def test_pcen_matches_sequential_loop():
    spec = np.random.default_rng(0).uniform(0.0, 4.0, (50, 16)).astype(
        np.float32)
    tc, fr = 0.4, FRAME_RATE
    t = tc * fr
    s = (np.sqrt(1 + 4 * t * t) - 1) / (2 * t * t)
    got = _np(pcen(spec, fr, time_constant=tc, device=CPU))
    want = _pcen_loop(spec.astype(np.float64), s, 0.98, 2.0, 0.5, 1e-6)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_pcen_gain_invariance():
    base = np.random.default_rng(1).uniform(0.5, 1.5, (1, 24)).astype(
        np.float32)
    spec = np.repeat(base, 200, axis=0)
    a = _np(pcen(spec, FRAME_RATE, gain=1.0, device=CPU))
    b = _np(pcen(100.0 * spec, FRAME_RATE, gain=1.0, device=CPU))
    np.testing.assert_allclose(a[-1], b[-1], rtol=0.02, atol=0.02)


def test_pcen_onset_emphasis():
    spec = np.zeros((100, 4), np.float32)
    spec[50:] = 1.0
    out = _np(pcen(spec, FRAME_RATE, device=CPU))
    assert out[50, 0] > 1.5 * out[99, 0]


def test_pcen_on_mel_pipeline():
    t = np.arange(PCEN_SR // 2) / PCEN_SR
    x = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    mel = mel_spectrogram(x, PCEN_CFG, PCEN_SR, n_mels=32, device=CPU)
    out = _np(pcen(mel, FRAME_RATE))
    assert out.shape == tuple(mel.shape)
    assert np.all(np.isfinite(out)) and out.min() >= -1e-5


def test_pcen_validates_args():
    with pytest.raises(ValueError):
        pcen(torch.ones((4, 4)), FRAME_RATE, time_constant=0.0)


def test_pcen_streaming_zi_matches_oneshot():
    spec = np.random.default_rng(7).uniform(0.0, 3.0, (120, 12)).astype(
        np.float32)
    one = _np(pcen(spec, FRAME_RATE, device=CPU))
    a, zf = pcen(spec[:70], FRAME_RATE, zi=spec[0], device=CPU)
    b, _ = pcen(spec[70:], FRAME_RATE, zi=zf, device=CPU)
    np.testing.assert_allclose(np.concatenate([_np(a), _np(b)]), one,
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (SR, 4096, 84, 12, 32.703194),
    (SR, 4096, 48, 12, 110.0),
    (22050.0, 2048, 60, 24, 55.0),
])
def test_cqt_filterbank_byte_identical(args):
    got, want = cqt_filterbank(*args), ref.cqt_filterbank(*args)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_chroma", [12, 24])
def test_tonnetz_basis_byte_identical(n_chroma):
    got, want = _tonnetz_basis(n_chroma), ref._tonnetz_basis(n_chroma)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_cqt_extractors_match_reference():
    x = np.random.default_rng(40).uniform(-1, 1, (2, SR // 2)).astype(
        np.float32)
    _close(pseudo_cqt(x, CFG, SR, n_bins=48, fmin=110.0, device=CPU),
           ref.pseudo_cqt(x, REF_CFG, SR, n_bins=48, fmin=110.0))
    _close(chroma_cqt(x, CFG, SR, device=CPU), ref.chroma_cqt(x, REF_CFG, SR))


@pytest.mark.parametrize("kw", [{}, dict(time_constant=0.1, gain=0.8,
                                         bias=1.0, power=0.25, eps=1e-3)])
def test_pcen_matches_reference(kw):
    spec = np.random.default_rng(41).uniform(0.0, 4.0, (2, 90, 16)).astype(
        np.float32)
    _close(pcen(spec, FRAME_RATE, device=CPU, **kw),
           ref.pcen(jnp.asarray(spec), FRAME_RATE, **kw))


def test_reference_pcen_state_continues_in_the_port():
    spec = np.random.default_rng(42).uniform(0.0, 3.0, (2, 100, 12)).astype(
        np.float32)
    _, zf_ref = ref.pcen(jnp.asarray(spec[:, :60]), FRAME_RATE,
                         zi=jnp.asarray(spec[:, 0]))
    want, want_zf = ref.pcen(jnp.asarray(spec[:, 60:]), FRAME_RATE,
                             zi=zf_ref)
    got, got_zf = pcen(spec[:, 60:], FRAME_RATE, zi=np.asarray(zf_ref),
                       device=CPU)
    _close(got, want)
    _close(got_zf, want_zf)
