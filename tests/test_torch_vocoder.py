"""The port's phase vocoder (`crlot_tpu_torch.vocoder`) on the CPU.

Mirrors `tests/test_vocoder.py` case for case with its gates (the duration
law to 2 %, the dominant frequency within 3 Hz and the amplitude to 10 %,
rate 1 above 60 dB in the interior, the octave shifts within 5 Hz, the
errors); its `slow` case stays `slow` here, and `chip_smoke.py` phase 38
runs it on the card. Then holds the port against the reference on the
same seeded input:

- `_princarg` equal value for value; `torch.round` rounds half to even, as
  `jnp.round` does;
- `time_stretch` and `pitch_shift` above 60 dB against the reference's
  output, the reference's own gate for rate 1 against the input. The two
  STFTs and `angle`s differ by ulps, and the float32 cumsum over frames
  carries the phase error along (measured on these 1 s signals: 62.45 dB
  at rate 1, 65.7 at 0.8, 70.7 at 1.5; pitch shifts 70.7–97.7 dB);
- the lengths equal the reference's, and the exact-mod carrier ramp keeps
  the reference's 46 340 frame-size limit.

Deviation: the port sums the phase increments along the frames in float64,
mod 2*pi (`vocoder._running_sum`), where the reference sums them in
float32. A float32 running sum in sequence (`torch.cumsum` on the card)
missed the reference's own 60 dB gate at rate 1 on 30 s: 41.38 dB on an
H100 (`chip_smoke.py` phase 38); `test_float32_running_sum_loses_the_phase`
is the witness on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crlot_tpu.vocoder as jv
from crlot_tpu.core.types import StftConfig as JConfig

from crlot_tpu_torch.core.types import StftConfig
from crlot_tpu_torch.metrics import snr_db
from crlot_tpu_torch.vocoder import (
    _princarg,
    _running_sum,
    pitch_shift,
    time_stretch,
)

SR = 48000
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone(freq, seconds=1.0, amp=0.5):
    t = np.arange(int(SR * seconds)) / SR
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _dominant_hz(x, sr=SR):
    x = np.asarray(x, np.float64)
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return np.argmax(spec) * sr / len(x)


def _cfg(hop=256):
    return StftConfig(frame_size=1024, hop_size=hop, center=True)


def _jcfg(hop=256):
    return JConfig(frame_size=1024, hop_size=hop, center=True)


# ---------------------------------------------------------------------------
# mirrors of tests/test_vocoder.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.75, 1.5, 2.0])
def test_stretch_duration(rate):
    x = _tone(440.0)
    y = time_stretch(x, _cfg(), rate, device=CPU).numpy()
    assert y.shape[-1] == pytest.approx(len(x) * rate, rel=0.02)


@pytest.mark.parametrize("rate", [0.75, 1.5])
def test_stretch_preserves_pitch(rate):
    x = _tone(440.0)
    y = time_stretch(x, _cfg(), rate, device=CPU).numpy()
    assert _dominant_hz(y) == pytest.approx(440.0, abs=3.0)
    mid = y[len(y) // 4 : -len(y) // 4]
    assert np.max(np.abs(mid)) == pytest.approx(0.5, rel=0.1)


def _interior_snr(x, y):
    n = min(len(x), len(y))
    a, b = x[2048 : n - 2048], y[2048 : n - 2048]
    return 10 * np.log10(np.sum(a**2) / np.sum((a - b) ** 2))


def test_stretch_rate_one_near_identity():
    x = _tone(440.0)
    y = time_stretch(x, _cfg(), 1.0, device=CPU).numpy()
    snr = _interior_snr(x, y)
    assert snr > 60.0, snr


@pytest.mark.slow
def test_stretch_long_signal_phase_precision():
    """30 s of an off-grid tone at rate 1: the exact-mod carrier ramp keeps
    the interior above 60 dB."""
    x = _tone(440.0, seconds=30.0)
    y = time_stretch(x, _cfg(), 1.0, device=CPU).numpy()
    snr = _interior_snr(x, y)
    assert snr > 60.0, snr


def test_stretch_frame_size_limit():
    with pytest.raises(ValueError):
        time_stretch(np.zeros(65536 * 2, np.float32),
                     StftConfig(frame_size=65536, hop_size=16384), 1.5,
                     device=CPU)


def test_stretch_multichannel():
    x = np.stack([_tone(440.0), _tone(880.0)])
    y = time_stretch(x, _cfg(), 1.5, device=CPU).numpy()
    assert y.shape[0] == 2
    assert _dominant_hz(y[0]) == pytest.approx(440.0, abs=3.0)
    assert _dominant_hz(y[1]) == pytest.approx(880.0, abs=3.0)


@pytest.mark.parametrize("semi,expected", [(12.0, 880.0), (-12.0, 220.0)])
def test_pitch_shift_octaves(semi, expected):
    x = _tone(440.0)
    y = pitch_shift(x, _cfg(), semi, device=CPU).numpy()
    assert y.shape[-1] == len(x)
    assert _dominant_hz(y) == pytest.approx(expected, abs=5.0)


def test_bad_rate_raises():
    with pytest.raises(ValueError):
        time_stretch(_tone(440.0), _cfg(), 0.0, device=CPU)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_princarg_equals_reference_and_rounds_half_even():
    rng = np.random.default_rng(50)
    p = rng.uniform(-40.0, 40.0, 100_000).astype(np.float32)
    assert np.array_equal(_princarg(torch.from_numpy(p)).numpy(),
                          np.asarray(jv._princarg(jnp.asarray(p))))
    half = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32)
    assert np.array_equal(torch.round(torch.from_numpy(half)).numpy(),
                          np.asarray(jnp.round(jnp.asarray(half))))
    assert np.array_equal(np.abs(np.round(half)), [0, 2, 2, 0, 2, 2])


@pytest.mark.parametrize("rate", [0.8, 1.0, 1.5])
def test_stretch_matches_reference(rate):
    x = np.stack([_tone(440.0), _tone(1234.5, amp=0.3)])
    y = time_stretch(x, _cfg(), rate, device=CPU).numpy()
    want = np.asarray(jv.time_stretch(x, _jcfg(), rate))
    assert y.shape == want.shape
    assert snr_db(want, y) > 60.0


@pytest.mark.parametrize("semi", [-12.0, -1.0, 3.0, 7.0])
def test_pitch_shift_matches_reference(semi):
    x = _tone(440.0)
    y = pitch_shift(x, _cfg(), semi, device=CPU).numpy()
    want = np.asarray(jv.pitch_shift(x, _jcfg(), semi))
    assert y.shape == want.shape == x.shape
    assert snr_db(want, y) > 60.0


def test_pitch_shift_rank3_raises_like_reference():
    x = np.zeros((2, 2, 4800), np.float32)
    with pytest.raises(ValueError) as want:
        jv.pitch_shift(x, _jcfg(), 3.0)
    with pytest.raises(ValueError) as got:
        pitch_shift(x, _cfg(), 3.0, device=CPU)
    assert str(got.value) == str(want.value)



def test_float32_running_sum_loses_the_phase():
    """The increments of an off-grid tone over 30 s of frames (5 625 at hop
    256, 0.607 rad each: 440 Hz is 18.125 Hz above bin 9): a float32
    running sum in sequence strays up to 7.6e-3 rad, where the 60 dB gate
    allows 1e-3; the port's float64 sum mod 2*pi stays within float32's
    resolution of the wrapped phase (2.4e-7)."""
    rng = np.random.default_rng(51)
    inc = (2 * np.pi * 18.125 * 256 / SR
           + 1e-4 * rng.standard_normal(5625)).astype(np.float32)
    exact = np.cumsum(inc.astype(np.float64))

    def wrapped_err(got):
        d = np.asarray(got, np.float64) - exact
        return np.max(np.abs((d + np.pi) % (2 * np.pi) - np.pi))

    assert wrapped_err(np.cumsum(inc, dtype=np.float32)) > 5e-3
    port = _running_sum(torch.from_numpy(inc[:, None]))[:, 0].numpy()
    assert wrapped_err(port) < 1e-6
