"""The port's effects (`crlot_tpu_torch.effects`) on the CPU.

Mirrors `tests/test_effects.py` (its 10 cases, same gates: the interior
against scipy.signal.lfilter within 1e-6, the inversion round trips above
100 dB, chunked pre-emphasis bit-exact and chunked de-emphasis above 90
dB, the G.711 closed form within 1e-6, the codes' range and monotonicity,
8-bit mu-law above 30 dB), then holds the port against the reference on
the same seeded input:

- `preemphasis` and `mu_compress` within 2.4e-7 (a few ulps of |x| <= 1:
  XLA contracts the multiply-subtract, torch rounds it twice),
  `mu_expand` and `mu_law_decode` within 1e-6 (the closed-form gate above;
  expm1 reaches mu, so an ulp there is 1.2e-7 of the result);
  `deemphasis` at >= 120 dB SNR (the reference's scan is float32, the
  port's float64);
- `mu_law_encode` code for code, and `mu_compress(quantize=True)` on the
  same level (within 2.4e-7), on inputs whose unrounded code lies at least
  1e-3 from a level boundary: nearer one, an ulp between torch's `log1p`
  and XLA's may move a code.
"""

import numpy as np
import pytest
import scipy.signal
import torch

from crlot_tpu import effects as ref

from crlot_tpu_torch.effects import (
    deemphasis,
    mu_compress,
    mu_expand,
    mu_law_decode,
    mu_law_encode,
    preemphasis,
)
from crlot_tpu_torch.metrics import snr_db

CPU = "cpu"
RNG = np.random.default_rng(42)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audio(n=8000):
    t = np.arange(n) / 16000.0
    x = 0.5 * np.sin(2 * np.pi * 220 * t) + 0.1 * RNG.standard_normal(n)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _np(t):
    return t.numpy()


# ---------------------------------------------------------------------------
# pre/de-emphasis (mirrors tests/test_effects.py)
# ---------------------------------------------------------------------------

def test_preemphasis_matches_scipy_interior():
    x = _audio()
    got = _np(preemphasis(x, coef=0.97, device=CPU))
    want = scipy.signal.lfilter([1.0, -0.97], [1.0], x)
    np.testing.assert_allclose(got[1:], want[1:], atol=1e-6)
    assert abs(got[0] - 0.03 * x[0]) < 1e-6


def test_deemphasis_inverts_preemphasis():
    x = _audio()
    y = _np(deemphasis(preemphasis(x, coef=0.97, device=CPU), coef=0.97))
    assert snr_db(x, y) > 100.0


def test_preemphasis_streaming_zi_matches_oneshot():
    x = _audio()
    one = _np(preemphasis(x, device=CPU))
    a = _np(preemphasis(x[:3000], device=CPU))
    b = _np(preemphasis(x[3000:], zi=x[2999:3000], device=CPU))
    np.testing.assert_array_equal(np.concatenate([a, b]), one)


def test_deemphasis_streaming_zi_matches_oneshot():
    x = _audio()
    y = preemphasis(x, device=CPU)
    one = _np(deemphasis(y))
    a = deemphasis(y[:3000])
    b = deemphasis(y[3000:], zi=a[-1:])
    assert snr_db(one, np.concatenate([_np(a), _np(b)])) > 90.0


def test_preemphasis_batched():
    x = np.stack([_audio(), 2 * _audio()])
    got = _np(preemphasis(x, device=CPU))
    np.testing.assert_allclose(got[0], _np(preemphasis(x[0], device=CPU)),
                               atol=0)


# ---------------------------------------------------------------------------
# mu-law
# ---------------------------------------------------------------------------

def test_mu_compress_closed_form():
    x = np.linspace(-1, 1, 101).astype(np.float32)
    got = _np(mu_compress(x, device=CPU))
    want = np.sign(x) * np.log1p(255.0 * np.abs(x)) / np.log1p(255.0)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_mu_expand_inverts_compress():
    x = _audio()
    y = _np(mu_expand(mu_compress(x, device=CPU)))
    assert snr_db(x, y) > 100.0


@pytest.mark.parametrize("bits", [8, 10])
def test_mu_law_codes_in_range_and_monotone(bits):
    x = np.linspace(-1, 1, 4097).astype(np.float32)
    codes = _np(mu_law_encode(x, bits=bits, device=CPU))
    assert codes.dtype == np.int32
    assert codes.min() == 0 and codes.max() == (1 << bits) - 1
    assert np.all(np.diff(codes) >= 0)


def test_mu_law_roundtrip_snr():
    x = _audio()
    y = _np(mu_law_decode(mu_law_encode(x, bits=8, device=CPU), bits=8))
    assert snr_db(x, y) > 30.0
    q = _np(mu_compress(x, quantize=True, device=CPU))
    z = _np(mu_compress(y, device=CPU))
    np.testing.assert_allclose(q, z, atol=2e-3)


def test_mu_law_decode_hits_exact_levels():
    codes = torch.arange(256, dtype=torch.int32)
    x = mu_law_decode(codes)
    back = _np(mu_law_encode(x))
    np.testing.assert_array_equal(back, np.arange(256))


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

def _signal(seed, n=6000):
    rng = np.random.default_rng(seed)
    return np.clip(0.4 * rng.standard_normal((2, n)), -0.99, 0.99).astype(
        np.float32)


@pytest.mark.parametrize("coef", [0.97, 0.5])
def test_emphasis_matches_reference(coef):
    x = _signal(1)
    got = _np(preemphasis(x, coef=coef, device=CPU))
    want = np.asarray(ref.preemphasis(x, coef=coef))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    zi = x[:, :1] * 0.5
    np.testing.assert_allclose(
        _np(preemphasis(x, coef=coef, zi=zi, device=CPU)),
        np.asarray(ref.preemphasis(x, coef=coef, zi=zi)), rtol=0, atol=2.4e-7)
    assert snr_db(np.asarray(ref.deemphasis(want, coef=coef)),
                  _np(deemphasis(want, coef=coef, device=CPU))) >= 120.0
    assert snr_db(np.asarray(ref.deemphasis(want, coef=coef, zi=zi)),
                  _np(deemphasis(want, coef=coef, zi=zi,
                                 device=CPU))) >= 120.0


def test_companding_matches_reference():
    x = np.concatenate([_signal(2).ravel(), np.linspace(-1.2, 1.2, 999,
                                                        dtype=np.float32)])
    for mu in (255.0, 1023.0):
        np.testing.assert_allclose(
            _np(mu_compress(x, mu=mu, device=CPU)),
            np.asarray(ref.mu_compress(x, mu=mu)), rtol=0, atol=2.4e-7)
        y = np.asarray(ref.mu_compress(x, mu=mu))
        np.testing.assert_allclose(
            _np(mu_expand(y, mu=mu, device=CPU)),
            np.asarray(ref.mu_expand(y, mu=mu)), rtol=0, atol=1e-6)
    for bits in (8, 10):
        codes = np.arange(1 << bits, dtype=np.int32)
        np.testing.assert_allclose(
            _np(mu_law_decode(codes, bits=bits, device=CPU)),
            np.asarray(ref.mu_law_decode(codes, bits=bits)), rtol=0,
            atol=1e-6)


@pytest.mark.parametrize("bits", [8, 10])
def test_codes_match_reference_away_from_level_boundaries(bits):
    """Code for code where the unrounded code (float64) is at least 1e-3
    from a boundary k + 1/2; the test keeps >= 90 % of its inputs."""
    mu = float((1 << bits) - 1)
    x = np.random.default_rng(3).uniform(-1, 1, 20000).astype(np.float32)
    u = (np.sign(x) * np.log1p(mu * np.abs(x.astype(np.float64)))
         / np.log1p(mu) + 1.0) / 2.0 * mu
    keep = np.abs(u - np.floor(u) - 0.5) >= 1e-3
    assert keep.mean() >= 0.9
    x = x[keep]
    got = _np(mu_law_encode(x, bits=bits, device=CPU))
    want = np.asarray(ref.mu_law_encode(x, bits=bits))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    q = _np(mu_compress(x, mu=mu, quantize=True, device=CPU))
    q_ref = np.asarray(ref.mu_compress(x, mu=mu, quantize=True))
    np.testing.assert_array_equal(np.rint((q + 1.0) * mu / 2.0),
                                  np.rint((q_ref + 1.0) * mu / 2.0))
    np.testing.assert_allclose(q, q_ref, rtol=0, atol=2.4e-7)
